"""Detection, segmentation, pose, oriented-box and classification result containers
(counterpart of `lpc_yolo_tpu/engine/results.py`: Boxes :18-83, OBBoxes :85-136,
Masks :138-204, Probs :206-247 and Results :249-472; `keypoints` is a plain
(n, K, 3) f32 array, as in the JAX Results :260, :271). Numpy arrays on the host,
so `cpu`, `numpy`, `cuda` and `to` are the identity, as in the JAX package.

`Boxes` rows are [x1, y1, x2, y2, conf, cls], or [x1, y1, x2, y2, id, conf, cls]
once a tracker has run. `Masks.xy` traces each mask's outer borders without
OpenCV (`data/cvops.py::find_external_contours`, cv2.findContours
RETR_EXTERNAL CHAIN_APPROX_SIMPLE) and keeps the largest by `contour_area`.
`Results.summary`, `tojson`, `verbose` and `save_txt` write what the JAX ones
write, string for string. `plot`, `save` and `save_crop` draw and write with
cv2 (`utils/plotting.py`), which they import lazily; without it they raise an
ImportError. `plot` draws an OBB result's rotated boxes, as the reference
does; the JAX `plot` draws their axis-aligned hulls (ROADMAP Queue 3).
`show` needs a display and is not ported.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.cvops import contour_area, find_external_contours
from ..ops.boxes import rbox_hull, xywhr2xyxyxyxy


class HostArray:
    """The device moves of a container of host numpy arrays: each is the identity (JAX :70-83)."""

    def cpu(self):
        return self

    def numpy(self):
        return self

    def cuda(self):
        return self

    def to(self, *args, **kwargs):
        return self


class Boxes(HostArray):
    """Detection boxes (N, 6) = [x1, y1, x2, y2, conf, cls], or (N, 7) with a track id at column 4."""

    def __init__(self, data: np.ndarray, orig_shape: Tuple[int, int]):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, 6) if data.size % 7 else data.reshape(-1, 7)
        if data.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 box columns, got {data.shape}")
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
        return self.data[:, -2]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, -1]

    @property
    def id(self) -> Optional[np.ndarray]:
        """The track ids (column 4 of a 7-column row), None before a tracker has run."""
        return self.data[:, 4] if self.data.shape[1] == 7 else None

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


class OBBoxes(HostArray):
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


class Masks(HostArray):
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

    @property
    def xy(self):
        """Each mask's largest outer border (by area, the first of equal ones) as a (K, 2) f32 polygon in
        frame pixels; (0, 2) for an empty mask."""
        out = []
        h0, w0 = self.orig_shape
        for m in self.data:
            mm = (np.asarray(m) > 0.5).astype(np.uint8)
            cs = find_external_contours(mm)
            if not cs:
                out.append(np.zeros((0, 2), np.float32))
                continue
            c = max(cs, key=contour_area).reshape(-1, 2).astype(np.float32)
            c[:, 0] *= w0 / mm.shape[1]
            c[:, 1] *= h0 / mm.shape[0]
            out.append(c)
        return out

    @property
    def xyn(self):
        """`xy` divided by the frame's (w, h)."""
        h0, w0 = self.orig_shape
        return [p / np.array([w0, h0], np.float32) for p in self.xy]


class Probs(HostArray, np.ndarray):
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


class Results(HostArray):
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

    def update(self, boxes: Optional[np.ndarray] = None) -> "Results":
        """Replace the boxes' rows when given (JAX :288-291)."""
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        return self

    def new(self) -> "Results":
        """An empty Results over the same frame."""
        return Results(self.orig_img, self.path, self.names, speed=self.speed)

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5, conf: bool = True,
             labels: bool = True, boxes: bool = True, masks: bool = True, kpt_line: bool = True,
             img: Optional[np.ndarray] = None) -> np.ndarray:
        """The frame (or `img`) with the masks, the boxes and their labels ("id:<k> " first once tracked),
        the keypoints and a classifier's top five drawn on a copy; HWC uint8 BGR (JAX :293-343). An OBB
        result draws its rotated boxes."""
        from ..utils.plotting import Annotator, colors

        im = (img if img is not None else self.orig_img).copy()
        ann = Annotator(im, line_width=line_width)
        if masks and self.masks is not None and len(self.masks):
            cls_ids = [int(c) for c in self.boxes.data[:, -1]] if self.boxes is not None else range(len(self.masks))
            ann.masks(np.asarray(self.masks.data), [colors(c, bgr=True) for c in cls_ids])
        if boxes and self.obb is not None:
            corners = self.obb.xyxyxyxy
            for i, row in enumerate(self.obb.data):
                cf, c = row[5], row[6]
                name = self.names.get(int(c), str(int(c)))
                txt = (f"{name} {cf:.2f}" if conf else name) if labels else ""
                ann.box_label(corners[i], txt, color=colors(int(c), bgr=True), rotated=True)
        elif boxes and self.boxes is not None:
            ids = self.boxes.id
            for i, row in enumerate(self.boxes.data):
                cf, c = row[-2], row[-1]
                name = self.names.get(int(c), str(int(c)))
                if ids is not None:
                    name = f"id:{int(ids[i])} {name}"
                txt = (f"{name} {cf:.2f}" if conf else name) if labels else ""
                ann.box_label(row[:4], txt, color=colors(int(c), bgr=True))
        if self.keypoints is not None:
            for k in np.asarray(self.keypoints):
                ann.kpts(k, kpt_line=kpt_line)
        if self.probs is not None:
            top5 = np.argsort(-np.asarray(self.probs))[:5]
            for li, j in enumerate(top5):
                ann.text((6, 28 + 22 * li), f"{self.names.get(int(j), j)} {float(self.probs[j]):.2f}")
        return ann.result()

    def save(self, filename: str) -> str:
        """Write `plot()` to `filename` with cv2.imwrite."""
        from ..utils import require_cv2

        require_cv2("Results.save").imwrite(str(filename), self.plot())
        return filename

    def save_crop(self, save_dir, file_name: str = "im.jpg") -> None:
        """Each box's crop (`save_one_box`: grown by 1.02 and 10 px, clipped) to save_dir/<class name>/
        file_name (stem1, stem2, ... after the first); nothing for a classifier (JAX :345-359)."""
        if self.probs is not None or self.boxes is None:
            return
        from ..utils.plotting import save_one_box

        for row in self.boxes.data:
            c = int(row[-1])
            save_one_box(row[:4], self.orig_img, file=Path(save_dir) / self.names.get(c, str(c)) / file_name)

    def summary(self, normalize: bool = False, decimals: int = 5) -> list:
        """One dict a row: name, class, confidence, box, and the track id, mask polygon and keypoints
        where there are some; a classifier's top-1 (JAX :361-408)."""
        h, w = self.orig_shape

        def rnd(v, d=decimals):
            return round(float(v), d)

        if self.probs is not None:
            return [{"name": self.names.get(self.probs.top1, str(self.probs.top1)), "class": self.probs.top1,
                     "confidence": rnd(self.probs.top1conf)}]
        rows = []
        if self.boxes is None:
            return rows
        ids = self.boxes.id
        kpts = np.asarray(self.keypoints) if self.keypoints is not None else None
        seg_xy = self.masks.xy if self.masks is not None else None
        for i, row in enumerate(np.asarray(self.boxes.data)):
            x1, y1, x2, y2 = row[:4].tolist()
            cf, c = float(row[-2]), int(row[-1])
            if normalize:
                x1, x2, y1, y2 = x1 / w, x2 / w, y1 / h, y2 / h
            d = {"name": self.names.get(c, str(c)), "class": c, "confidence": rnd(cf),
                 "box": {"x1": rnd(x1), "y1": rnd(y1), "x2": rnd(x2), "y2": rnd(y2)}}
            if ids is not None:
                d["track_id"] = int(ids[i])
            if seg_xy is not None and i < len(seg_xy) and len(seg_xy[i]):
                pts = np.asarray(seg_xy[i], np.float64)
                if normalize:
                    pts = pts / [w, h]
                d["segments"] = {"x": [rnd(v) for v in pts[:, 0]], "y": [rnd(v) for v in pts[:, 1]]}
            if kpts is not None and i < len(kpts):
                kp = kpts[i].astype(np.float64)
                x, y = kp[:, 0], kp[:, 1]
                if normalize:
                    x, y = x / w, y / h
                d["keypoints"] = {"x": [rnd(v) for v in x], "y": [rnd(v) for v in y]}
                if kp.shape[1] > 2:
                    d["keypoints"]["visible"] = [rnd(v) for v in kp[:, 2]]
            rows.append(d)
        return rows

    def tojson(self, normalize: bool = False, decimals: int = 5) -> str:
        """`summary()` as indented JSON."""
        return json.dumps(self.summary(normalize=normalize, decimals=decimals), indent=2)

    to_json = tojson

    def verbose(self) -> str:
        """The count of each class, '3 persons, 1 car, '; a classifier's top five with their scores."""
        if self.probs is not None:
            return ", ".join(f"{self.names.get(j, str(j))} {float(np.asarray(self.probs)[j]):.2f}"
                             for j in self.probs.top5) + ", "
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections), "
        cls = np.asarray(self.boxes.data)[:, -1].astype(int)
        return "".join(f"{n} {self.names.get(int(c), str(c))}{'s' * int(n > 1)}, "
                       for c, n in zip(*np.unique(cls, return_counts=True)))

    def save_txt(self, txt_file: str, save_conf: bool = False) -> str:
        """One line a box, 'cls xc yc w h' normalised by the frame (and the confidence with save_conf), to
        txt_file, whose folder is made (JAX :454-472)."""
        lines = []
        if self.boxes is not None:
            h, w = self.orig_shape
            for row in self.boxes.data:
                x1, y1, x2, y2 = row[:4]
                cf, c = row[-2], row[-1]
                xc, yc = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
                bw, bh = (x2 - x1) / w, (y2 - y1) / h
                line = f"{int(c)} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f}"
                if save_conf:
                    line += f" {cf:.6f}"
                lines.append(line)
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file
