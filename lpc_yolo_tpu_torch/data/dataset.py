"""YOLO-format detection dataset: dataset YAML, image scan, labels, npz label cache.

Counterpart of `lpc_yolo_tpu/data/dataset.py` (`check_det_dataset`,
`img2label_path`, `YOLODataset`) for box, polygon, keypoint and DOTA quad
label rows. The label cache has the JAX package's format and name
(`<images dir>.labels.npz`, a hash of the file names and modification times,
the labels as an object array), so a cache written by either package serves
both. As in the JAX package the hash does not cover `kpt_shape`: a cache
written without it holds no keypoints. With `obb` the hash also covers the
word "obb": the JAX package writes an oriented set's cache under the plain
hash, with the rectangles of its normalized quads in `bboxes` and `rboxes`,
and the port reads neither (see `YOLODataset`).

Layout:
    <root>/images/<split>/*.jpg
    <root>/labels/<split>/*.txt   # rows: cls cx cy w h (normalized xywh), or cls x1 y1 x2 y2 ... (polygon),
                                  # or with kpt_shape (K, ndim) cls cx cy w h (x y [v]) * K (pose),
                                  # or with obb cls x1 y1 x2 y2 x3 y3 x4 y4 (a DOTA quad, normalized)
    data.yaml: {path, train, val, names, nc[, kpt_shape, flip_idx]}

Images are read with OpenCV, imported only when a file has to be decoded.
With `cache_images="disk"` each image's decoded BGR array is kept in a `.npy`
twin beside it; a machine without OpenCV reads datasets whose twins exist.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import yaml

from .cvops import min_area_rect
from . import png

IMG_SUFFIXES = {".bmp", ".dng", ".jpeg", ".jpg", ".mpo", ".png", ".tif", ".tiff", ".webp"}


def check_det_dataset(data: Union[str, Path, Dict]) -> Dict:
    """Parse a dataset YAML (or dict) into {path, train, val, names, nc}.

    A relative `path:` is taken relative to the YAML itself. Bundled dataset
    names ('coco8.yaml') need the JAX package's settings and downloads and are
    not ported: they raise NotImplementedError.
    """
    if not isinstance(data, dict):
        p = Path(data)
        if not p.exists() and p.suffix in (".yaml", ".yml") and p.name == str(data):
            raise NotImplementedError(f"bundled dataset names ({data}) are not ported; pass the path of a dataset YAML")
    if isinstance(data, dict):
        d = dict(data)
    else:
        d = yaml.safe_load(Path(data).read_text())
        d.setdefault("path", str(Path(data).parent))
    root = Path(d.get("path", "."))
    if not root.is_absolute() and not isinstance(data, dict):
        root = Path(data).parent / root

    def _resolve(p):
        p = Path(p)
        return str(p if p.is_absolute() else root / p)

    out = {"path": str(root)}
    for split in ("train", "val", "test"):
        if d.get(split):
            v = d[split]
            out[split] = [_resolve(x) for x in v] if isinstance(v, list) else _resolve(v)
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = {int(k): str(v) for k, v in (names or {}).items()}
    out["nc"] = int(d.get("nc", len(out["names"])))
    if d.get("kpt_shape"):
        out["kpt_shape"] = tuple(d["kpt_shape"])
    if d.get("flip_idx"):
        out["flip_idx"] = list(d["flip_idx"])
    if not out["names"]:
        out["names"] = {i: str(i) for i in range(out["nc"])}
    return out


def img2label_path(img_path: str) -> str:
    """images/... -> labels/... with .txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def imread(path: str) -> np.ndarray:
    """Decode an image file to an HWC uint8 BGR array (`data/png.py::read_image`: a PNG without OpenCV, any
    other format with it)."""
    try:
        return png.read_image(path)
    except ImportError as e:
        raise ImportError(f"decoding {path} needs OpenCV, which is not installed: save each image's decoded BGR "
                          f"array as a .npy twin beside it and pass cache_images='disk'") from e


def read_image(path: str, cache_images: Optional[str] = None) -> np.ndarray:
    """An image file's HWC uint8 BGR array: with `cache_images` ("ram" or "disk") from its `.npy` twin where
    there is one, else decoded by `imread`; with "disk" the decoded array is then kept as the twin."""
    twin = Path(path).with_suffix(".npy")
    if cache_images and twin.exists():
        return np.load(twin)
    im = imread(path)
    if cache_images == "disk":
        # written under a temporary name and renamed, so that a worker thread reading the same
        # image (the loader repeats the last sample of a padded batch) never sees half a file
        fd, tmp = tempfile.mkstemp(dir=twin.parent, suffix=".npy.tmp")
        with os.fdopen(fd, "wb") as f:
            np.save(f, im)
        os.replace(tmp, twin)
    return im


def rotated_boxes(segments: List[np.ndarray], bboxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Each label row's rotated box (n, 5) f32 [cx, cy, w, h, angle in radians], the first four in units of
    the frame's longer side s: `min_area_rect` (cv2.minAreaRect) of the row's normalized points scaled by
    (w0 / s, h0 / s), i.e. of its quad in pixels up to the isotropic 1 / s, which changes no angle. A box
    row's points are its rectangle's corners.

    The JAX parse (`data/dataset.py:183-190`) takes minAreaRect of the normalized quad itself and the
    validator and the OBB transform scale its w by w0 and h by h0 (`engine/validator.py:195-198`,
    `data/augment.py:656-660`): exact on a square frame only. On a square frame these are the JAX rows
    (scale 1), and `x * s * gain` is the JAX `x * w0 * gain`."""
    h0, w0 = hw
    s = max(h0, w0)
    out = np.zeros((len(bboxes), 5), np.float32)
    pts = [seg if len(seg) else np.array([[b[0] - b[2] / 2, b[1] - b[3] / 2], [b[0] + b[2] / 2, b[1] - b[3] / 2],
                                          [b[0] + b[2] / 2, b[1] + b[3] / 2], [b[0] - b[2] / 2, b[1] + b[3] / 2]],
                                         np.float32) for seg, b in zip(segments, bboxes)]
    scale = np.array([w0 / s, h0 / s], np.float32)
    for k in sorted({len(p) for p in pts}):
        rows = [i for i, p in enumerate(pts) if len(p) == k]
        r = min_area_rect(np.stack([np.asarray(pts[i], np.float32) * scale for i in rows]))
        out[rows, :4] = r[:, :4]
        out[rows, 4] = np.deg2rad(r[:, 4].astype(np.float64)).astype(np.float32)
    return out


class YOLODataset:
    """Detection dataset over YOLO-format image/label folders (box, polygon and, with `kpt_shape`, keypoint
    rows; JAX :85-216). With `kpt_shape` (K, ndim) a row of 4 + K * ndim values is a pose row and every
    image's labels hold `keypoints` (n, K, ndim) f32, zeros for its box and polygon rows.

    With `obb` (an oriented set, DOTA's rows `cls x1 y1 x2 y2 x3 y3 x4 y4`) the labels are parsed as for any
    polygon row (the quad in `segments`, its axis-aligned hull in `bboxes`), and `get_item_raw` adds each
    row's rotated box from the frame's size (`rotated_boxes`): the JAX parse makes it from the normalized
    quad, which is right on a square frame only (ROADMAP Queue 3)."""

    def __init__(self, img_path: Union[str, Path, List], cache: bool = True, cache_images: Union[bool, str] = False,
                 kpt_shape: Optional[Tuple[int, int]] = None, obb: bool = False):
        self.img_path = (
            [str(p) for p in img_path] if isinstance(img_path, (list, tuple)) else str(img_path)
        )
        self.kpt_shape = tuple(kpt_shape) if kpt_shape else None
        self.obb = obb
        self.im_files = self._scan_images()
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = self._load_labels(cache)
        # 'ram' keeps decoded BGR arrays in memory (from a .npy twin where there is one); 'disk' keeps a
        # decoded .npy twin beside each image
        self.cache_images = "ram" if cache_images is True else (cache_images or None)
        if self.cache_images not in (None, "ram", "disk"):
            raise ValueError(f"cache_images must be False, True, 'ram' or 'disk', got {cache_images!r}")
        self._ram: List[Optional[np.ndarray]] = [None] * len(self.im_files)
        self._rboxes: List[Optional[np.ndarray]] = [None] * len(self.im_files)  # `rotated_boxes`, on first use

    def _scan_images(self) -> List[str]:
        # a directory, a .txt listing, or a list of those
        parts = self.img_path if isinstance(self.img_path, (list, tuple)) else [self.img_path]
        files: List[str] = []
        for part in parts:
            p = Path(part)
            if p.is_dir():
                files += sorted(str(f) for f in p.rglob("*") if f.suffix.lower() in IMG_SUFFIXES)
            elif p.is_file() and p.suffix == ".txt":
                files += [line.strip() for line in p.read_text().splitlines() if line.strip()]
            else:
                raise FileNotFoundError(f"dataset path {p} not found")
        if not files:
            raise FileNotFoundError(f"no images found in {self.img_path}")
        return files

    def _cache_path(self) -> Path:
        base = self.img_path[0] if isinstance(self.img_path, list) else self.img_path
        return Path(base).with_suffix(".labels.npz")

    def _hash(self) -> str:
        h = hashlib.sha1()
        for f in self.im_files + self.label_files:
            h.update(f.encode())
            try:
                h.update(str(os.path.getmtime(f)).encode())
            except OSError:
                pass
        if self.obb:
            h.update(b"obb")
        return h.hexdigest()

    def _load_labels(self, cache: bool) -> List[Dict]:
        cpath, key = self._cache_path(), self._hash()
        if cache and cpath.exists():
            try:
                # the cache holds an object array that this package or the JAX package wrote
                z = np.load(cpath, allow_pickle=True)
                if str(z["hash"]) == key:
                    return list(z["labels"])
            except (OSError, ValueError, KeyError, EOFError, pickle.UnpicklingError):
                pass  # unreadable or foreign: parse the label files again
        labels = []
        nkd = self.kpt_shape[0] * self.kpt_shape[1] if self.kpt_shape else -1
        no_kpts = np.zeros(self.kpt_shape or (0, 0), np.float32)
        for lf in self.label_files:
            cls_list, box_list, seg_list, kpt_list = [], [], [], []
            if os.path.exists(lf):
                for line in Path(lf).read_text().splitlines():
                    vals = line.split()
                    if not vals:
                        continue
                    c = int(float(vals[0]))
                    coords = np.array(vals[1:], np.float32)
                    if self.kpt_shape and len(coords) == 4 + nkd:  # pose row: cls cx cy w h (x y [v]) * K
                        cls_list.append(c)
                        box_list.append(coords[:4])
                        seg_list.append(np.zeros((0, 2), np.float32))
                        kpt_list.append(coords[4:].reshape(self.kpt_shape))
                    elif len(coords) == 4:  # box row: cls cx cy w h
                        cls_list.append(c)
                        box_list.append(coords)
                        seg_list.append(np.zeros((0, 2), np.float32))
                        kpt_list.append(no_kpts)
                    elif len(coords) >= 6 and len(coords) % 2 == 0:  # polygon row
                        pts = coords.reshape(-1, 2)
                        lo, hi = pts.min(0), pts.max(0)
                        cls_list.append(c)
                        box_list.append(
                            np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]], np.float32)
                        )
                        seg_list.append(pts)
                        kpt_list.append(no_kpts)
            entry = {
                "cls": np.array(cls_list, np.int32),
                "bboxes": np.array(box_list, np.float32).reshape(-1, 4),
                "segments": seg_list,
            }
            if self.kpt_shape:
                entry["keypoints"] = np.stack(kpt_list) if kpt_list else np.zeros((0,) + self.kpt_shape, np.float32)
            labels.append(entry)
        if cache:
            try:
                np.savez_compressed(cpath, hash=key, labels=np.array(labels, dtype=object))
            except OSError:
                pass  # a read-only dataset directory: labels are parsed again next time
        return labels

    def __len__(self) -> int:
        return len(self.im_files)

    def load_image(self, i: int) -> np.ndarray:
        """The HWC uint8 BGR image i: from the RAM cache, its .npy twin, or decoded with OpenCV. The
        RAM cache fills from the twin where there is one (a machine without OpenCV has only twins)."""
        if self.cache_images == "ram" and self._ram[i] is not None:
            return self._ram[i]
        im = read_image(self.im_files[i], self.cache_images)
        if self.cache_images == "ram":
            self._ram[i] = im
        return im

    def get_item_raw(self, i: int) -> Dict:
        """One un-augmented sample: BGR image + normalized xywh labels and polygons ((k, 2) each; (0, 2)
        for a box row), the normalized keypoints (n, K, ndim) where the labels hold them, and for an
        oriented set the rotated boxes (n, 5) in units of the frame's longer side (`rotated_boxes`, computed
        on the image's first load and kept)."""
        out = {
            "img": self.load_image(i),
            "cls": self.labels[i]["cls"].copy(),
            "bboxes": self.labels[i]["bboxes"].copy(),
            "segments": [s.copy() for s in self.labels[i].get("segments", [])],
            "path": self.im_files[i],
        }
        if "keypoints" in self.labels[i]:
            out["keypoints"] = self.labels[i]["keypoints"].copy()
        if self.obb:
            if self._rboxes[i] is None:  # once an image: its labels and frame size do not change
                self._rboxes[i] = rotated_boxes(out["segments"], out["bboxes"], out["img"].shape[:2])
            out["rboxes"] = self._rboxes[i].copy()
        return out
