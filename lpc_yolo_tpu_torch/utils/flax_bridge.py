"""Weight bridge: JAX package variables <-> the port's state_dict.

The inverse of `lpc_yolo_tpu/utils/torch_port.py::port_state_dict`, on plain
numpy: the JAX variables `{"params", "batch_stats"}` are a nested dict of
arrays, and nothing here imports jax.

* Each `_<digits>` name component becomes `.<digits>`:
  `model_28/one2one_cv2_0_0/conv/kernel` -> `model.28.one2one_cv2.0.0.conv.weight`.
* Conv kernels go HWIO -> OIHW (`transpose(3, 2, 0, 1)`); a depthwise
  (kh, kw, 1, C) kernel becomes (C, 1, kh, kw).
* BN scale/bias/mean/var become weight/bias/running_mean/running_var, and
  each BN gets `num_batches_tracked = 0` so `load_state_dict(strict=True)`
  holds.

`train_state_from_flax` carries a JAX `TrainState`'s numpy trees (params,
batch_stats, the SGD momentum trace or AdamW's two moments, ema_params, the
counters) into the port's `TrainState`; `train_state_to_flax` is its inverse
for the trees. `train_state_dict` / `train_state_from_dict` do the same for
the whole state dict that flax writes for a JAX `TrainState`
(`lpc_yolo_tpu/engine/train_step.py:31-37`, optimizer chains :84-105), the
tree of a trainer's `.ckpt`. Every tree built here has its dict keys in
sorted order at every level, the order of a JAX pytree's dicts, so flax's
msgpack of a JAX state and of the port's state agree byte for byte.

`random_variables` fills a shape tree from a numpy seed, so the JAX package
(through `jax.eval_shape`) and the port (through `flax_shapes`) get the same
numbers without either running the other's init.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_TORCH_BN = {v: k for k, v in _BN_LEAVES.items()}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items") and not hasattr(v, "shape"):
            yield from _flatten(dict(v), prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def flax_name_to_torch(path: Tuple[str, ...]) -> str:
    """('model_28', 'one2one_cv2_0_0', 'conv') -> 'model.28.one2one_cv2.0.0.conv'."""
    return ".".join(re.sub(r"_(\d+)(?=_|$)", r".\1", c) for c in path)


def torch_name_to_flax(name: str) -> Tuple[str, ...]:
    """'model.28.one2one_cv2.0.0.conv' -> ('model_28', 'one2one_cv2_0_0', 'conv')."""
    merged = []
    for c in name.split("."):
        if c.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{c}"
        else:
            merged.append(c)
    return tuple(merged)


def flax_to_state_dict(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX variables (nested dicts of arrays) -> the port's state_dict tensors."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for col in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(col, {})):
            arr = np.asarray(arr, np.float32)
            mod, leaf = flax_name_to_torch(path[:-1]), path[-1]
            if path[-2] == "bn":
                sd[f"{mod}.{_BN_LEAVES[leaf]}"] = torch.from_numpy(arr.copy())
                if leaf == "mean":
                    sd[f"{mod}.num_batches_tracked"] = torch.tensor(0)
            elif leaf == "kernel" and arr.ndim == 4:
                sd[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
            elif leaf == "bias":
                sd[f"{mod}.bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no torch counterpart for {col}/{'/'.join(path)} {arr.shape}")
    return sd


def _flax_slot(name: str, ndim: int) -> Optional[Tuple[str, Tuple[str, ...], bool]]:
    """A state_dict entry's place in the JAX variables: (collection, path, is a
    conv kernel); None for the entries JAX does not have (num_batches_tracked)."""
    mod, leaf = name.rsplit(".", 1)
    path = torch_name_to_flax(mod)
    if leaf == "num_batches_tracked":
        return None
    if path[-1] == "bn":
        flax_leaf = _TORCH_BN[leaf]
        return ("batch_stats" if flax_leaf in ("mean", "var") else "params"), path + (flax_leaf,), False
    if leaf == "weight" and ndim == 4:
        return "params", path + ("kernel",), True
    if leaf == "bias":
        return "params", path + ("bias",), False
    raise KeyError(f"no JAX counterpart for {name}")


def flax_shapes(model: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The JAX variables' shape tree that corresponds to `model`'s state_dict."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        slot = _flax_slot(name, t.dim())
        if slot is not None:
            col, path, kernel = slot
            _set(tree[col], path, tuple(t.permute(2, 3, 1, 0).shape if kernel else t.shape))
    return tree


def _sorted_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The tree with every dict's keys in sorted order (a JAX pytree's order)."""
    return {k: _sorted_tree(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


def state_dict_to_flax(named: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """State_dict-named tensors -> JAX variables as numpy trees (kernels OIHW -> HWIO), keys sorted."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, t in named.items():
        slot = _flax_slot(name, t.dim())
        if slot is not None:
            col, path, kernel = slot
            t = t.detach().float().cpu()
            _set(tree[col], path, np.ascontiguousarray((t.permute(2, 3, 1, 0) if kernel else t).numpy()))
    return _sorted_tree(tree)


def train_state_from_flax(model: nn.Module, cfg, params, batch_stats, momentum, ema_params, step: int = 0,
                          ema_updates: int = 0, opt_step: Optional[int] = None, device=None, nu=None):
    """A JAX TrainState's numpy trees -> the port's TrainState on `model`.

    `momentum` is the SGD trace inside the optax state, or for AdamW the
    first moment `mu` of its ScaleByAdamState; `nu` is AdamW's second moment
    and is required for an AdamW `cfg` (trees shaped like `params`).
    `opt_step` is the optimizer's own count, which trails `step` by the
    skipped steps; it defaults to `step`.
    """
    from ..engine.train_step import init_train_state

    if (cfg.optimizer == "adamw") != (nu is not None):
        raise ValueError(f"optimizer {cfg.optimizer!r}: pass nu (AdamW's second moment) for AdamW, and only then")
    load_flax(model, {"params": params, "batch_stats": batch_stats})
    state = init_train_state(model, cfg, device)
    with torch.no_grad():
        for dst, tree in ((state.momentum, momentum), (state.ema_params, ema_params), (state.nu, nu)):
            if tree is None:
                continue
            for k, v in flax_to_state_dict({"params": tree}).items():
                dst[k].copy_(v)
    state.step, state.ema_updates = int(step), int(round(float(ema_updates)))
    state.opt_step = state.step if opt_step is None else int(opt_step)
    return state


def train_state_to_flax(state) -> Dict[str, Any]:
    """The port's TrainState -> numpy trees {'params', 'batch_stats', 'momentum', 'ema_params'},
    and 'nu' when the state is AdamW's."""
    live = state_dict_to_flax({**state.params, **state.batch_stats})
    out = {"params": live["params"], "batch_stats": live["batch_stats"],
           "momentum": state_dict_to_flax(state.momentum)["params"],
           "ema_params": state_dict_to_flax(state.ema_params)["params"]}
    if state.nu:
        out["nu"] = state_dict_to_flax(state.nu)["params"]
    return out


def injected_momentum(count: int, cfg) -> np.ndarray:
    """The `decay` that optax's `inject_hyperparams(trace)` holds after `count` updates: the momentum
    schedule read at the last update's count (count - 1; count 0 before any update), in f32 as JAX
    computes `momentum_at` (`tests/test_torch_ckpt.py` holds it to optax)."""
    n = np.float32(max(count - 1, 0))
    warm = np.clip(n / np.float32(max(cfg.warmup_steps, 1)), np.float32(0.0), np.float32(1.0))
    return np.asarray(np.float32(cfg.warmup_momentum) + np.float32(cfg.momentum - cfg.warmup_momentum) * warm,
                      np.float32)


def train_state_dict(state, cfg) -> Dict[str, Any]:
    """The port's TrainState -> the state dict flax writes for the JAX `TrainState` of the same run:
    `step` (int32), `params`, `batch_stats`, `opt_state` (the optax chain's states for `cfg.optimizer`,
    each `count` the updates applied, `opt_step`), `ema_params`, `ema_updates` (f32)."""
    trees = train_state_to_flax(state)
    count = np.asarray(state.opt_step, np.int32)
    if cfg.optimizer == "adamw":  # clip, adamw = (scale_by_adam, masked decay, scale_by_learning_rate)
        opt = {"0": {}, "1": {"0": {"count": count, "mu": trees["momentum"], "nu": trees["nu"]},
                              "1": {"inner_state": {}}, "2": {"count": count}}}
    else:  # clip, masked decay, inject_hyperparams(trace), scale_by_learning_rate
        opt = {"0": {}, "1": {"inner_state": {}},
               "2": {"count": count, "hyperparams": {"decay": injected_momentum(state.opt_step, cfg)},
                     "hyperparams_states": {"decay": {"count": count}},
                     "inner_state": {"trace": trees["momentum"]}},
               "3": {"count": count}}
    return {"step": np.asarray(state.step, np.int32), "params": trees["params"], "batch_stats": trees["batch_stats"],
            "opt_state": opt, "ema_params": trees["ema_params"], "ema_updates": np.asarray(state.ema_updates, np.float32)}


def train_state_from_dict(model: nn.Module, cfg, tree: Mapping[str, Any], device=None):
    """A JAX `TrainState`'s state dict (a trainer `.ckpt`'s tree) -> the port's TrainState on `model`.
    Raises when the state's optimizer is not `cfg.optimizer`."""
    opt = tree["opt_state"]
    adamw = "3" not in opt
    if adamw != (cfg.optimizer == "adamw"):
        raise ValueError(f"the checkpoint holds {'AdamW' if adamw else 'SGD'} state, the run uses {cfg.optimizer!r}: "
                         f"resume with the optimizer settings of the run that wrote it")
    if adamw:
        adam = opt["1"]["0"]
        momentum, nu, count = adam["mu"], adam["nu"], adam["count"]
    else:
        momentum, nu, count = opt["2"]["inner_state"]["trace"], None, opt["2"]["count"]
    return train_state_from_flax(model, cfg, tree["params"], tree["batch_stats"], momentum, tree["ema_params"],
                                 step=int(tree["step"]), ema_updates=float(tree["ema_updates"]),
                                 opt_step=int(count), device=device, nu=nu)


def random_variables(shapes: Dict[str, Any], seed: int = 0) -> Dict[str, Any]:
    """Fill every leaf of a variables shape tree from one numpy generator.

    Leaves are visited in sorted path order, so any tree with the same paths
    and shapes gets the same arrays. Kernels are U(±sqrt(3/fan_in)) (unit
    gain); BN scales U(0.5, 1.5), BN biases and means U(±0.2), variances
    U(0.5, 1.5) (positive); conv biases U(±0.5), random rather than the init
    constants so scores spread and the top-k order is stable.
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(shapes.get(col, {})):
            shape = tuple(getattr(leaf, "shape", leaf))
            kind = path[-1]
            if kind == "kernel":
                bound = np.sqrt(3.0 / max(int(np.prod(shape[:-1])), 1))
                arr = rng.uniform(-bound, bound, shape)
            elif kind in ("scale", "var"):
                arr = rng.uniform(0.5, 1.5, shape)
            elif kind == "mean" or (kind == "bias" and path[-2] == "bn"):
                arr = rng.uniform(-0.2, 0.2, shape)
            elif kind == "bias":
                arr = rng.uniform(-0.5, 0.5, shape)
            else:
                raise KeyError(f"unknown variable {col}/{'/'.join(path)}")
            _set(out.setdefault(col, {}), path, arr.astype(np.float32))
    return out


def load_flax(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load JAX variables into `model` (strict: every entry must match)."""
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in flax_to_state_dict(variables).items()}, strict=True)
    return model
