"""The `YOLO` facade of the port (counterpart of `lpc_yolo_tpu/engine/model.py::YOLO`).

`YOLO(cfg, device=..., nc=...)` builds the model from one of the port's own
YAMLs (or a path), with weights made from a seed or loaded from JAX variables
through the weight bridge; `.predict(frames)` serves it, `.train(data=...)`
trains it on a dataset (or `.train(batches=...)` on an iterable of host
batches) and `.val(data=...)` measures it on a dataset. Checkpoints, export
and the other tasks wait for later slices.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import torch

from ..nn.compiler import build_model, guess_model_scale, yaml_model_load
from ..utils import resolve_device
from ..utils.flax_bridge import flax_shapes, load_flax, random_variables
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


class YOLO:
    """User-facing facade: `YOLO("yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml", device="cuda")`.

    seed: fill the weights from this numpy seed through the bridge (the same
    numbers the JAX package gets from `random_variables` of its shape tree);
    None keeps PyTorch's default init. nc: the number of classes, when it is
    not the YAML's (the JAX facade's `nc=`); the names are then "0", "1", ...
    """

    def __init__(self, model: Union[str, Path] = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml",
                 device: Union[str, torch.device, None] = None, seed: Optional[int] = 0, nc: Optional[int] = None):
        if not str(model).endswith((".yaml", ".yml")):
            raise NotImplementedError("the torch port builds from model YAMLs only; checkpoints come later")
        self.device = resolve_device(device)
        yaml_path = _resolve_yaml(model)
        d = yaml_model_load(yaml_path)
        d["scale"] = guess_model_scale(model) or d["scale"]
        if "v10Detect" not in yaml_path.read_text():
            raise NotImplementedError("the torch port serves v10Detect models only so far")
        self.task = "v10"
        self.model_yaml: Dict[str, Any] = d
        self.model = build_model(d, device=self.device, nc=nc)
        if seed is not None:
            self.load_flax(random_variables(flax_shapes(self.model), seed))
        self.names = dict(COCO80) if self.model.nc == len(COCO80) else {i: str(i) for i in range(self.model.nc)}

    def load_flax(self, variables: Dict[str, Any]) -> "YOLO":
        """Load JAX-package variables (nested dicts of numpy arrays)."""
        load_flax(self.model, variables)
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
