"""Detection, segmentation, pose, oriented-box and classification result containers
(counterpart of `lpc_yolo_tpu/engine/results.py` Boxes :18, OBBoxes :85-136,
Masks :138-168, Probs :206-247 and the detect, segment, pose, OBB and classify subset of Results :249;
`keypoints` is a plain (n, K, 3) f32 array, as in the JAX Results :260, :271). Numpy arrays on the host;
plotting, saving and the masks' polygons (`Masks.xy`, `.xyn`, which need
cv2.findContours) wait for a later slice."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.boxes import rbox_hull, xywhr2xyxyxyxy


class Boxes:
    """Detection boxes (N, 6) = [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, data: np.ndarray, orig_shape: Tuple[int, int]):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, 6)
        if data.shape[-1] != 6:
            raise ValueError(f"expected 6 box columns, got {data.shape}")
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx) -> "Boxes":
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self) -> np.ndarray:
        return self.data[:, :4]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 4]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def xywh(self) -> np.ndarray:
        b = self.xyxy
        return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], axis=-1)

    @property
    def xyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h], dtype=np.float32)

    @property
    def xywhn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h], dtype=np.float32)


class OBBoxes:
    """Oriented boxes (N, 7) = [cx, cy, w, h, angle (radians), conf, cls] in frame pixels."""

    def __init__(self, data: np.ndarray, orig_shape: Tuple[int, int]):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, 7)
        if data.shape[-1] != 7:
            raise ValueError(f"expected 7 obb columns, got {data.shape}")
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx) -> "OBBoxes":
        return OBBoxes(self.data[idx], self.orig_shape)

    @property
    def xywhr(self) -> np.ndarray:
        return self.data[:, :5]

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 5]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 6]

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """(N, 4, 2) corners (`ops/boxes.py::xywhr2xyxyxyxy`)."""
        return xywhr2xyxyxyxy(torch.from_numpy(self.xywhr)).numpy()

    @property
    def xyxyxyxyn(self) -> np.ndarray:
        """(N, 4, 2) corners normalized by the frame's size."""
        h, w = self.orig_shape
        return self.xyxyxyxy / np.array([w, h], self.data.dtype)

    @property
    def xyxy(self) -> np.ndarray:
        """(N, 4) axis-aligned hulls (`ops/boxes.py::rbox_hull`)."""
        return rbox_hull(torch.from_numpy(self.xywhr)).numpy()


class Masks:
    """Instance masks (N, H, W), bool, at the frame's size."""

    def __init__(self, data: np.ndarray, orig_shape: Tuple[int, int]):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx):
        """An int gives the (H, W) mask array; anything else a Masks of the rows."""
        if isinstance(idx, (int, np.integer)):
            return self.data[idx]
        return Masks(self.data[idx], self.orig_shape)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype


class Probs(np.ndarray):
    """One image's class probabilities (nc,) f32 with the top-1 / top-5 accessors (JAX
    `engine/results.py:206-247`): an ndarray subclass, so array uses keep working."""

    def __new__(cls, data):
        return np.asarray(data, np.float32).view(cls)

    @property
    def data(self) -> np.ndarray:
        return np.asarray(self)

    @property
    def top1(self) -> int:
        return int(np.argmax(np.asarray(self)))

    @property
    def top5(self):
        return np.argsort(-np.asarray(self))[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(np.asarray(self)[self.top1])

    @property
    def top5conf(self) -> np.ndarray:
        return np.asarray(self)[self.top5]

    # host numpy, as in the JAX Probs: the device moves are the identity
    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self


class Results:
    """One image's detections, its instance masks for a segment model, its keypoints (n, K, 3) in frame
    pixels for a pose model (each None when no row was kept), its oriented boxes for an OBB model (the
    boxes are then their hulls) and its class probabilities (`Probs`) for a classify model, which has no
    boxes. Indexing takes the boxes' rows only, as in the JAX Results (:281-285)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str],
                 boxes: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None, obb: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None, speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = keypoints
        self.obb = OBBoxes(obb, self.orig_shape) if obb is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {}

    def __len__(self) -> int:
        return len(self.boxes) if self.boxes is not None else 0

    def __iter__(self) -> Iterator["Results"]:
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx) -> "Results":
        r = Results(self.orig_img, self.path, self.names, speed=self.speed)
        if self.boxes is not None:
            r.boxes = self.boxes[idx]
        return r

