"""Reference-layout `.pt` checkpoints (counterpart of the JAX facade's `_load_checkpoint`,
`lpc_yolo_tpu/engine/model.py:143-175`, and of `utils/torch_port.py::port_state_dict`).

A `.pt` from the reference trainer is a pickled dict whose `ema` (or, once
`strip_optimizer` has run, `model`, in fp16, with `ema` None) is the whole
nn.Module: its `.yaml` is the architecture dict, its `.names` the class names,
its `state_dict()` the weights under the names the port's modules already have
(`nn/modules.py`). `read_pt` unpickles it as the JAX facade does, and
`load_pt_state` loads the weights strictly, but for the entries that the JAX
`port_state_dict` skips as well: the head's frozen `dfl.conv.weight` (the port
decodes the DFL analytically) and the BatchNorms' `num_batches_tracked`.
Unpickling a reference `.pt` needs the package that pickled it (`ultralytics`);
`write_pt` writes the same layout around the port's own model, which either
facade reads.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

_SKIP_SUFFIXES = ("num_batches_tracked", "dfl.conv.weight")


def read_pt(path: Union[str, Path]) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor], Optional[Dict[int, str]]]:
    """A reference `.pt` -> (architecture dict, f32 state_dict, names or None). The module is `ema`, or
    `model` where `ema` is missing or None; the scale comes from the file's stem (`yolov\\d+([nsmblx])`) when
    the architecture names none."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    module = (ckpt.get("ema") or ckpt["model"]) if isinstance(ckpt, dict) else ckpt
    module = module.float()
    d = dict(module.yaml)
    if not d.get("scale"):
        m = re.search(r"yolov\d+([nsmblx])", Path(path).stem)
        if m:
            d["scale"] = m.group(1)
    names = getattr(module, "names", None)
    names = {int(k): str(v) for k, v in names.items()} if isinstance(names, dict) else None
    return d, module.state_dict(), names


def load_pt_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a `.pt`'s state_dict into `model`: every entry must match but for the frozen DFL conv and the
    `num_batches_tracked` counters, which neither side needs."""
    keep = {k: v for k, v in state.items() if not k.endswith(_SKIP_SUFFIXES)}
    dev = next(model.parameters()).device
    res = model.load_state_dict({k: v.to(dev) for k, v in keep.items()}, strict=False)
    missing = [k for k in res.missing_keys if not k.endswith(_SKIP_SUFFIXES)]
    if missing or res.unexpected_keys:
        raise KeyError(f"the .pt does not fit the model: missing {missing[:8]} ({len(missing)}), "
                       f"unexpected {res.unexpected_keys[:8]} ({len(res.unexpected_keys)})")
    return model


def _reference_module(model: nn.Module, yaml_dict: Dict[str, Any], names: Dict[int, str]) -> nn.Module:
    """An fp16 copy of `model` on the CPU as the reference pickles one: `.yaml`, `.names`, and the v10 / v8
    heads' frozen DFL conv (weights 0..reg_max-1), which a loader skips."""
    m = copy.deepcopy(model).cpu().eval()
    m.yaml, m.names = dict(yaml_dict), dict(names)
    head = m.model[-1]
    reg_max = getattr(m, "reg_max", 16)
    if m.task in ("v10", "v8"):
        head.dfl = nn.Module()
        head.dfl.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        head.dfl.conv.weight.copy_(torch.arange(reg_max, dtype=torch.float32).view(1, reg_max, 1, 1))
    return m.half()


@torch.no_grad()
def write_pt(path: Union[str, Path], model: nn.Module, yaml_dict: Dict[str, Any], names: Dict[int, str],
             ema: bool = False) -> str:
    """Write `model` as the reference trainer's checkpoint dict (reference `trainer.py::save_model` and
    `strip_optimizer`): with `ema`, the fp16 module under `ema` and `model` None, as a run's `last.pt` holds
    it; without, under `model` with `ema` None, as `strip_optimizer` leaves it."""
    m = _reference_module(model, yaml_dict, names)
    ckpt = {"epoch": -1, "best_fitness": None, "model": None if ema else m, "ema": m if ema else None,
            "updates": 0 if ema else None, "optimizer": None, "train_args": {}, "date": None, "version": None}
    torch.save(ckpt, path)
    return str(path)
