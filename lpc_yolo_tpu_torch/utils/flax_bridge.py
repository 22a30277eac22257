"""Weight bridge: JAX package variables <-> the port's state_dict.

The inverse of `lpc_yolo_tpu/utils/torch_port.py::port_state_dict`, on plain
numpy: the JAX variables `{"params", "batch_stats"}` are a nested dict of
arrays, and nothing here imports jax.

* Each `_<digits>` name component becomes `.<digits>`:
  `model_28/one2one_cv2_0_0/conv/kernel` -> `model.28.one2one_cv2.0.0.conv.weight`.
* Conv kernels go HWIO -> OIHW (`transpose(3, 2, 0, 1)`); a depthwise
  (kh, kw, 1, C) kernel becomes (C, 1, kh, kw). A Dense kernel (in, out)
  becomes a Linear weight (out, in). The 3-D kernels of flax's
  MultiHeadDotProductAttention (`query` / `key` / `value` (C, nh, hd), `out`
  (nh, hd, C)) and their (nh, hd) biases keep the JAX layout
  (`nn/transformer.py::MultiHeadAttention` reads them so).
* BN scale/bias/mean/var become weight/bias/running_mean/running_var, and
  each BN gets `num_batches_tracked = 0` so `load_state_dict(strict=True)`
  holds; a LayerNorm's scale/bias become weight/bias. The leaves' names tell
  them apart, whatever the module's name (the RT-DETR decoder's BNs are
  `input_proj_<i>_1`).
* A bare parameter (`denoising_class_embed` (nc, hd), a contrastive head's
  rank-0 `logit_scale`; the attention zoo's (`nn/research.py`): ECA's (k, 1, 1)
  `conv`, ShuffleAttention's `cweight` / `cbias` / `sweight` / `sbias`,
  CrissCrossAttention's `gamma`, MHSA's `rel_h` / `rel_w`, SpatialGroupEnhance's
  (1, 1, 1, g) `weight`) keeps its name and layout; a `bias` of any rank (the
  contrastive heads' rank-0 ones, SpatialGroupEnhance's) is a bias like any
  other. SpatialGroupEnhance's `weight` is the one torch name that the rank
  does not place: a 4-D `weight` of shape (1, 1, 1, g > 1) is it, since no conv
  of a compiled graph has one input channel, one output channel and a 1 x g
  kernel. NAMAttention's BatchNorm leaves at a module's root map as any
  BatchNorm's. Every key is the mechanical name: SKAttention's `fc` beside
  `fc_0`..`fc_3` is a Linear with children, so no key is renamed. The neck
  blocks' bare leaves (LocalGlobalAttention's `prompt` and
  `top_down_transform`, SCSA's (k, 1, C / 4) `local_dwc`, `global_dwc_s` /
  `_m` / `_l` and their `<name>_bias`) are carried the same way, and so are
  the backbone families': Swin's f32 `relative_position_bias_table`
  ((2ws - 1)², nh) and ConvNeXt's layer scales `m_<i>_gamma`; MSBlock's
  `mid_<i>_<j>_in` is `mid.<i>.<j>_in` (a key component that starts with
  digits and an underscore joins the one before it on the way back), as
  ConvNeXt's `m_<i>_dwconv` is `m.<i>_dwconv`. Swin's and ConvNeXt's Dense
  layers are Linears (transposed), the FasterNet BatchNorms named `norm` are
  BatchNorms by their leaves, and a conv that a separate BatchNorm follows
  (InvertedBottleneck's biased `proj`, FasterNet's `proj` / `reduction`)
  keeps its own keys: only `nn/fuse.py` joins the two.
* Two leaves change their values, by the JAX module's name: ASFF's
  `up<j>/cv1` kernel, a flax ConvTranspose (kh, kw, in, out) that
  `lax.conv_transpose` applies unflipped, is the torch ConvTranspose2d weight
  (in, out, kh, kw) flipped in both spatial axes; DySample's `offset` conv
  orders its 2 * G output channels (G, 2) in JAX, (2, G) in the published
  module (G = groups * scale²), so its kernel and bias are permuted.

`train_state_from_flax` carries a JAX `TrainState`'s numpy trees (params,
batch_stats, the SGD momentum trace or AdamW's two moments, ema_params, the
counters) into the port's `TrainState`; `train_state_to_flax` is its inverse
for the trees. `train_state_dict` / `train_state_from_dict` do the same for
the whole state dict that flax writes for a JAX `TrainState`
(`lpc_yolo_tpu/engine/train_step.py:31-37`, optimizer chains :84-105), the
tree of a trainer's `.ckpt`. Every tree built here has its dict keys in
sorted order at every level, the order of a JAX pytree's dicts, so flax's
msgpack of a JAX state and of the port's state agree byte for byte.

`variables_from_flat` builds a tree from `/`-joined leaf names (the JAX ReID
encoder's `.npz` files). `random_variables` fills a shape tree from a numpy seed, so the JAX package
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
# a kernel's axes by rank, JAX layout -> torch layout (conv HWIO -> OIHW, Dense (in, out) -> Linear (out, in))
# and back
_TO_TORCH = {4: (3, 2, 0, 1), 3: (0, 1, 2), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 3: (0, 1, 2), 2: (1, 0)}
# parameters that are not a module's kernel, bias or scale: carried under their own name, untransposed
_BARE = {"denoising_class_embed", "logit_scale", "conv", "cweight", "cbias", "sweight", "sbias", "gamma", "rel_h",
         "rel_w", "weight", "prompt", "top_down_transform", "local_dwc", "global_dwc_s", "global_dwc_m", "global_dwc_l",
         "local_dwc_bias", "global_dwc_s_bias", "global_dwc_m_bias", "global_dwc_l_bias",
         "relative_position_bias_table"}
_UPSAMPLE_T = re.compile(r"up\d+$")
_LAYER_SCALE = re.compile(r"m_\d+_gamma$")  # ConvNeXt_Block's layer scales, bare leaves of the block


def _is_bare(leaf: str) -> bool:
    return leaf in _BARE or bool(_LAYER_SCALE.match(leaf))


def _is_upsample_t(module: Tuple[str, ...]) -> bool:
    """ASFF's `_UpsampleT` conv: the JAX module path ends in ('up<j>', 'cv1')."""
    return len(module) >= 2 and module[-1] == "cv1" and bool(_UPSAMPLE_T.match(module[-2]))


def _offset_order(a, to_torch: bool):
    """DySample's offset channels along axis 0: JAX's (G, 2) order <-> the published (2, G)."""
    g = a.shape[0] // 2
    rest = tuple(a.shape[1:])
    if to_torch:
        return a.reshape(g, 2, *rest).swapaxes(0, 1).reshape(2 * g, *rest)
    return a.reshape(2, g, *rest).swapaxes(0, 1).reshape(2 * g, *rest)


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
    """'model.28.one2one_cv2.0.0.conv' -> ('model_28', 'one2one_cv2_0_0', 'conv'); 'mid.1.0_in' -> ('mid_1_0_in',)."""
    merged = []
    for c in name.split("."):
        if merged and (c.isdigit() or re.match(r"\d+_", c)):
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
            prefix = f"{mod}." if mod else ""  # "" at the root of a module's own tree
            if leaf in _BN_LEAVES:  # a BatchNorm's or a LayerNorm's leaf, or a kernel's bias
                if leaf == "bias" and path[-2:-1] == ("offset",):
                    arr = _offset_order(arr, to_torch=True)
                sd[prefix + _BN_LEAVES[leaf]] = torch.from_numpy(arr.copy())
                if leaf == "mean":
                    sd[prefix + "num_batches_tracked"] = torch.tensor(0)
            elif leaf == "kernel" and arr.ndim in _TO_TORCH:
                if arr.ndim == 4 and _is_upsample_t(path[:-1]):
                    w = arr[::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    w = arr.transpose(_TO_TORCH[arr.ndim])
                if path[-2:-1] == ("offset",):
                    w = _offset_order(w, to_torch=True)
                sd[prefix + "weight"] = torch.from_numpy(np.ascontiguousarray(w))
            elif _is_bare(leaf):
                sd[prefix + leaf] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"no torch counterpart for {col}/{'/'.join(path)} {arr.shape}")
    return sd


def _flax_slot(name: str, ndim: int, shape: Optional[Tuple[int, ...]] = None):
    """A state_dict entry's place in the JAX variables: (collection, path, the permutation that
    takes the tensor to the JAX layout or None, a function applied to the torch tensor before it or
    None); None for the entries JAX does not have (num_batches_tracked). `shape` tells
    SpatialGroupEnhance's 4-D `weight` from a conv's."""
    mod, _, leaf = name.rpartition(".")
    path = torch_name_to_flax(mod) if mod else ()
    pre = (lambda t: _offset_order(t, to_torch=False)) if path[-1:] == ("offset",) else None
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", path + (_TORCH_BN[leaf],), None, None
    if leaf == "weight" and shape is not None and _is_sge_weight(shape):
        return "params", path + ("weight",), None, None
    if leaf == "weight" and ndim == 1:  # a BatchNorm's or a LayerNorm's scale
        return "params", path + ("scale",), None, None
    if leaf == "weight" and ndim == 4 and _is_upsample_t(path):
        return "params", path + ("kernel",), (2, 3, 0, 1), lambda t: t.flip(2, 3)
    if leaf == "weight" and ndim in _TO_FLAX:
        return "params", path + ("kernel",), _TO_FLAX[ndim], pre
    if leaf == "bias":
        return "params", path + ("bias",), None, pre
    if _is_bare(leaf):
        return "params", path + (leaf,), None, None
    raise KeyError(f"no JAX counterpart for {name}")


def _is_sge_weight(shape: Tuple[int, ...]) -> bool:
    return len(shape) == 4 and tuple(shape[:3]) == (1, 1, 1) and shape[3] > 1


def is_flax_kernel(name: str, ndim: int, shape: Optional[Tuple[int, ...]] = None) -> bool:
    """Whether a state_dict entry is a leaf named `kernel` in the JAX variables: the leaves the JAX optimizer
    weight-decays (`lpc_yolo_tpu/engine/train_step.py::_decay_mask`). Conv and Linear weights and flax
    attention's 3-D kernels are; biases (attention's (nh, hd) ones too), norm scales and
    `denoising_class_embed` are not, nor the attention zoo's bare leaves (give `shape` for a 4-D `weight`)."""
    slot = _flax_slot(name, ndim, shape)
    return slot is not None and slot[1][-1] == "kernel"


def flax_shapes(model: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The JAX variables' shape tree that corresponds to `model`'s state_dict."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        slot = _flax_slot(name, t.dim(), tuple(t.shape))
        if slot is not None:
            col, path, perm, _ = slot
            _set(tree[col], path, tuple(t.permute(perm).shape if perm else t.shape))
    return tree


def _sorted_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The tree with every dict's keys in sorted order (a JAX pytree's order)."""
    return {k: _sorted_tree(tree[k]) if isinstance(tree[k], dict) else tree[k] for k in sorted(tree)}


def state_dict_to_flax(named: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """State_dict-named tensors -> JAX variables as numpy trees (kernels OIHW -> HWIO), keys sorted."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, t in named.items():
        slot = _flax_slot(name, t.dim(), tuple(t.shape))
        if slot is not None:
            col, path, perm, pre = slot
            t = t.detach().float().cpu()
            t = pre(t) if pre else t
            _set(tree[col], path, (t.permute(perm) if perm else t).contiguous().numpy())  # rank 0 stays rank 0
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
    gain; an attention `query` / `key` / `value` kernel (C, nh, hd) has fan_in
    C, its `out` kernel (nh, hd, C) nh * hd); BN and LayerNorm scales
    U(0.5, 1.5), BN biases and means U(±0.2), variances U(0.5, 1.5)
    (positive); other biases U(±0.5), random rather than the init constants
    so scores spread and the top-k order is stable (a contrastive head's
    rank-0 `bias` too); a bare parameter (`denoising_class_embed`,
    `logit_scale`, the attention zoo's: ECA's `conv`, ShuffleAttention's gates,
    `gamma`, `rel_h` / `rel_w`, SpatialGroupEnhance's `weight`) U(±1), so no
    gate sits at its init's constant.
    """
    rng = np.random.default_rng(seed)
    out: Dict[str, Any] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(shapes.get(col, {})):
            shape = tuple(getattr(leaf, "shape", leaf))
            kind = path[-1]
            if kind == "kernel":
                fan_in = shape[0] if len(shape) == 3 and path[-2] != "out" else int(np.prod(shape[:-1]))
                bound = np.sqrt(3.0 / max(fan_in, 1))
                arr = rng.uniform(-bound, bound, shape)
            elif kind in ("scale", "var"):
                arr = rng.uniform(0.5, 1.5, shape)
            elif kind == "mean" or (kind == "bias" and path[-2:-1] == ("bn",)):
                arr = rng.uniform(-0.2, 0.2, shape)
            elif kind == "bias":
                arr = rng.uniform(-0.5, 0.5, shape)
            elif _is_bare(kind):
                arr = rng.uniform(-1.0, 1.0, shape)
            else:
                raise KeyError(f"unknown variable {col}/{'/'.join(path)}")
            _set(out.setdefault(col, {}), path, arr.astype(np.float32))
    return out


def load_flax(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load JAX variables into `model` (strict: every entry must match)."""
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in flax_to_state_dict(variables).items()}, strict=True)
    return model


def variables_from_flat(flat: Mapping[str, Any], base: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A nested variables tree from arrays keyed by the JAX `/`-joined paths ("params/conv0/kernel", as
    the JAX ReID encoder's `.npz` names them), each laid over a copy of `base`, whose other leaves stay."""
    tree: Dict[str, Any] = {}
    for path, leaf in _flatten(base or {}):
        _set(tree, path, leaf)
    for key, arr in flat.items():
        _set(tree, tuple(key.split("/")), np.asarray(arr))
    return tree
