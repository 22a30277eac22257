"""AutoBackend: one `forward(images)` over the artifacts the port writes (counterpart of
`lpc_yolo_tpu/nn/autobackend.py`; reference nn/autobackend.py).

The runtime follows the weights' suffix:
- `.onnx` runs through OpenCV's dnn module (`cv2.dnn.readNetFromONNX`), with the `.onnx.json` sidecar's output
  names. That runtime runs on the CPU, so it is opened only for `device="cpu"`: asked for the card (the default),
  it raises a ValueError rather than move the work to the CPU. OpenCV is reached by `utils.require_cv2`, so
  where it is not installed this raises an ImportError naming the feature, and nothing takes its place.
- `.torchscript` runs through `torch.jit.load(map_location=device)`, on the card unless the caller asks for
  the CPU, with the `config.txt` it carries.
- `.pt` loads through the port's `YOLO` and serves its `predict` (a v10 or v8 detection model).
- `.ckpt` is refused, as the JAX AutoBackend refuses it; any other suffix raises.

A single raw `pred` map of a detection head (4 + nc columns) is decoded on the host by
`ops/postprocess.py::v10_detections`, the NMS-free top-k, into (B, 300, 6); an artifact decoded in its graph
gives its (B, max_det, 6) as it is; a multi-output artifact (seg, pose) gives a dict by output name. The JAX
AutoBackend also sends an OBB map (4 + nc + 1 columns) and a classifier's probabilities to that decode, which
asserts on them; here they come back as they are (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..ops.postprocess import v10_detections
from ..utils import require_cv2, resolve_device


class AutoBackend:
    """Loads an artifact and exposes `forward(imgs)`, imgs (B, H, W, 3) f32 RGB in [0, 1]."""

    def __init__(self, weights: Union[str, Path], imgsz: int = 640, device: Union[str, torch.device, None] = None):
        self.path = str(weights)
        self.imgsz = imgsz
        suffix = Path(self.path).suffix.lower()
        if suffix == ".onnx":
            self.device = resolve_device(device)
            if self.device.type != "cpu":
                raise ValueError(f"the ONNX runtime of AutoBackend is cv2.dnn, which runs on the CPU; pass "
                                 f"device='cpu' to run '{weights}' there (asked for {self.device})")
            cv2 = require_cv2("the ONNX runtime of AutoBackend (cv2.dnn)")
            self._net = cv2.dnn.readNetFromONNX(self.path)
            sidecar = Path(self.path + ".json")
            self._meta(json.loads(sidecar.read_text()) if sidecar.exists() else {})
            self._fn, self.kind = self._onnx, "onnx"
        elif suffix == ".torchscript":
            self.device = resolve_device(device)
            extra = {"config.txt": ""}
            self._mod = torch.jit.load(self.path, map_location=self.device, _extra_files=extra).eval()
            try:
                meta = json.loads(extra["config.txt"])
            except ValueError:
                meta = {}
            self._meta(meta)
            self._fn, self.kind = self._torchscript, "torchscript"
        elif suffix == ".pt":
            from ..engine.model import YOLO

            self.device = resolve_device(device)
            self._yolo = YOLO(self.path, device=self.device)
            if self._yolo.task not in ("v10", "v8"):
                raise NotImplementedError(f"AutoBackend serves a .pt of a v10 or v8 detection model, not "
                                          f"task {self._yolo.task!r}")
            self._fn, self.kind = self._pt, "pt"
        elif suffix == ".ckpt":
            raise ValueError(".ckpt artifacts carry only weights; load via YOLO(path) of either package, or "
                             "export to onnx/torchscript")
        else:
            raise ValueError(f"unsupported weights '{weights}' (suffix {suffix})")

    def _meta(self, meta: dict) -> None:
        self.nc = meta.get("nc", 80)
        self.names = meta.get("outputs") or []

    def _decode(self, pred: np.ndarray) -> np.ndarray:
        """A raw detection map (4 + nc columns) through the host decode; anything else as it is."""
        if pred.ndim == 3 and pred.shape[-1] == 4 + self.nc and self.names in ([], ["pred"]):
            return v10_detections(torch.from_numpy(np.ascontiguousarray(pred)), 300, self.nc).numpy()
        return pred

    def _onnx(self, x: np.ndarray):
        self._net.setInput(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))), "images")
        if len(self.names) > 1:  # a multi-output (seg, pose) artifact
            return dict(zip(self.names, self._net.forward(self.names)))
        return self._decode(self._net.forward())

    def _torchscript(self, x: np.ndarray):
        nchw = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))).to(self.device)
        with torch.no_grad():
            out = self._mod(nchw)
        if isinstance(out, (tuple, list)):
            names = self.names if len(self.names) == len(out) else [f"output_{i}" for i in range(len(out))]
            return {k: v.cpu().numpy() for k, v in zip(names, out)}
        return self._decode(out.cpu().numpy())

    def _pt(self, x: np.ndarray):
        nchw = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))).to(self.device)
        with torch.no_grad():
            return self._yolo.model.predict(nchw).cpu().numpy()

    def forward(self, imgs: np.ndarray):
        """imgs (B, H, W, 3) f32 RGB in [0, 1] -> (B, max_det, 6) for a detection artifact, a dict of named
        arrays for a multi-output one, else the artifact's one output."""
        return self._fn(np.asarray(imgs, np.float32))

    __call__ = forward

    def warmup(self, batch: int = 1) -> None:
        self.forward(np.zeros((batch, self.imgsz, self.imgsz, 3), np.float32))
