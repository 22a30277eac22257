"""The `YOLO` facade of the port (counterpart of `lpc_yolo_tpu/engine/model.py::YOLO`).

`YOLO(cfg, device=..., nc=...)` builds the model from one of the port's own
YAMLs (or a path), with weights made from a seed or loaded from JAX variables
through the weight bridge; `YOLO("x.ckpt")` rebuilds it from a `.ckpt` that
`YOLO.save` of either package wrote (the JAX `_load_native_ckpt`, :90-120).
`.predict(frames)` serves it, `.train(data=...)` trains it on a dataset (or
`.train(batches=...)` on an iterable of host batches), `.val(data=...)`
measures it on a dataset, `.save(path)` writes it as a `.ckpt` the JAX
facade loads and `.load(weights)` takes over every weight whose name and
shape match. `.pt` files, export and the other tasks wait for later slices.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import torch

from ..nn.compiler import build_model, guess_model_scale, yaml_model_load
from ..utils import resolve_device
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.flax_bridge import flax_shapes, load_flax, random_variables, state_dict_to_flax
from ..utils.names import COCO80
from .predictor import Predictor

_CFG_ROOT = Path(__file__).resolve().parents[1] / "cfg" / "models"


def _resolve_yaml(name: Union[str, Path]) -> Path:
    """A model-config name or path -> the YAML file (scale letter stripped when needed)."""
    p = Path(name)
    if p.exists():
        return p
    unified = re.sub(r"(\d+)([nsmblx])(.+)?$", r"\1\3", p.stem) + p.suffix
    for cand in (_CFG_ROOT / "v10" / p.name, _CFG_ROOT / "v10" / unified):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"model config {name} not found (searched {_CFG_ROOT})")


def _read_model_ckpt(path: Union[str, Path]):
    """A `.ckpt` written by `YOLO.save` (either package) -> (model YAML dict, variables, meta)."""
    variables, meta = load_checkpoint(path)
    if meta.get("model_yaml") is None:
        raise ValueError(
            f"{path} has no embedded model config — trainer state checkpoints "
            "(weights/last.ckpt) resume via YOLO(...).train(resume=True); use "
            "model.save(path) to produce a standalone loadable artifact"
        )
    return meta["model_yaml"], {k: variables[k] for k in ("params", "batch_stats")}, meta


class YOLO:
    """User-facing facade: `YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml", device="cuda")`.

    seed: fill the weights from this numpy seed through the bridge (the same
    numbers the JAX package gets from `random_variables` of its shape tree);
    None keeps PyTorch's default init. nc: the number of classes, when it is
    not the YAML's (the JAX facade's `nc=`); the names are then "0", "1", ...
    A `.ckpt` brings its own weights, class count and names; `seed` is unused.
    """

    def __init__(self, model: Union[str, Path] = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml",
                 device: Union[str, torch.device, None] = None, seed: Optional[int] = 0, nc: Optional[int] = None):
        self.device = resolve_device(device)
        meta: Dict[str, Any] = {}
        if str(model).endswith(".ckpt"):
            d, variables, meta = _read_model_ckpt(model)
        elif str(model).endswith((".yaml", ".yml")):
            d = yaml_model_load(_resolve_yaml(model))
            d["scale"] = guess_model_scale(model) or d["scale"]
            variables = None
        else:
            raise NotImplementedError("the torch port builds from model YAMLs and .ckpt files only; .pt comes later")
        if not any(layer[2] == "v10Detect" for layer in d.get("backbone", []) + d.get("head", [])):
            raise NotImplementedError("the torch port serves v10Detect models only so far")
        self.task = "v10"
        self.model_yaml: Dict[str, Any] = d
        self.model = build_model(d, device=self.device, nc=nc or meta.get("nc"))
        if variables is not None:
            self.load_flax(variables)
        elif seed is not None:
            self.load_flax(random_variables(flax_shapes(self.model), seed))
        names = meta.get("names") or dict(COCO80)
        # JSON turned the int keys into str
        names = {int(k): v for k, v in names.items()} if isinstance(names, dict) else dict(enumerate(names))
        self.names = names if len(names) == self.model.nc else {i: str(i) for i in range(self.model.nc)}

    def load_flax(self, variables: Dict[str, Any]) -> "YOLO":
        """Load JAX-package variables (nested dicts of numpy arrays)."""
        load_flax(self.model, variables)
        return self

    def save(self, filename: Union[str, Path] = "saved_model.ckpt") -> str:
        """Write the weights and {nc, task, model_yaml, names} as a `.ckpt` that `YOLO(path)` of
        either package loads (JAX `engine/model.py:329-337`)."""
        meta = {"nc": self.model.nc, "task": self.task, "model_yaml": self.model_yaml, "names": self.names}
        save_checkpoint(Path(filename), state_dict_to_flax(self.model.state_dict()), meta)
        return str(filename)

    def load(self, weights: Union[str, Path, "YOLO"]) -> "YOLO":
        """Take over every weight of `weights` (a YOLO, a `.ckpt` or a YAML) whose name and shape
        match one of this model's, and keep the others (JAX `engine/model.py:339-351`)."""
        other = weights if isinstance(weights, YOLO) else YOLO(weights, device=self.device)
        theirs = other.model.state_dict()
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                if k in theirs and theirs[k].shape == v.shape:
                    v.copy_(theirs[k])
        return self

    def predict(self, source, conf: float = 0.25, imgsz: int = 640, batch: int = 1, max_det: int = 300,
                device: Union[str, torch.device, None] = None):
        """Detect in frames (HWC uint8 BGR ndarrays, lists of them, or image/video paths) -> [Results]."""
        predictor = Predictor(self.model, imgsz=imgsz, batch=batch, conf=conf, max_det=max_det,
                              names=self.names, device=device or self.device)
        return predictor(source)

    def val(self, data=None, device: Union[str, torch.device, None] = None, **kw) -> Dict[str, float]:
        """Validate on the `val` split of a dataset YAML (path or dict) -> the metrics dict.

        Options as `engine/validator.py::Validator` (imgsz, batch, conf, max_det,
        max_gt, workers, save_json, save_dir, anno_json, cache_images, dtype).
        It runs on the card unless device="cpu"; the validator stays on `self.validator`.
        """
        from .validator import Validator

        if data is None:
            raise ValueError("val needs data=<dataset yaml or dict>")
        self.validator = Validator(self, device=device or self.device, **kw)
        return self.validator(data)

    def train(self, batches: Optional[Iterable[Mapping[str, Any]]] = None, data=None,
              device: Union[str, torch.device, None] = None, **kw) -> Dict[str, float]:
        """Train on a dataset YAML (`data=`) or on an iterable of host batches (`batches=`);
        see `engine/trainer.py` for the options. Afterwards the facade holds the EMA
        weights. It runs on the card unless device="cpu". Returns the last validation's
        results dict (data=) or the last epoch's mean loss items (batches=)."""
        from .trainer import Trainer

        self.trainer = Trainer(self, batches, data=data, device=device or self.device, **kw)
        return self.trainer.train()
