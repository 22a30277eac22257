"""YOLO-format detection dataset: dataset YAML, image scan, labels, npz label cache.

Counterpart of `lpc_yolo_tpu/data/dataset.py` (`check_det_dataset`,
`img2label_path`, `YOLODataset`) for box and polygon label rows. The label
cache has the JAX package's format and name (`<images dir>.labels.npz`, a
hash of the file names and modification times, the labels as an object
array), so a cache written by either package serves both.

Layout:
    <root>/images/<split>/*.jpg
    <root>/labels/<split>/*.txt   # rows: cls cx cy w h (normalized xywh), or cls x1 y1 x2 y2 ... (polygon)
    data.yaml: {path, train, val, names, nc}

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
from typing import Dict, List, Optional, Union

import numpy as np
import yaml

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
    """Decode an image file to an HWC uint8 BGR array with OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"decoding {path} needs OpenCV, which is not installed: save each image's decoded BGR "
                          f"array as a .npy twin beside it and pass cache_images='disk'") from e
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(path)
    return im


class YOLODataset:
    """Detection dataset over YOLO-format image/label folders (box and polygon rows)."""

    def __init__(self, img_path: Union[str, Path, List], cache: bool = True, cache_images: Union[bool, str] = False):
        self.img_path = (
            [str(p) for p in img_path] if isinstance(img_path, (list, tuple)) else str(img_path)
        )
        self.im_files = self._scan_images()
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = self._load_labels(cache)
        # 'ram' keeps decoded BGR arrays in memory (from a .npy twin where there is one); 'disk' keeps a
        # decoded .npy twin beside each image
        self.cache_images = "ram" if cache_images is True else (cache_images or None)
        if self.cache_images not in (None, "ram", "disk"):
            raise ValueError(f"cache_images must be False, True, 'ram' or 'disk', got {cache_images!r}")
        self._ram: List[Optional[np.ndarray]] = [None] * len(self.im_files)
        if self.cache_images:
            self._npy_files = [Path(f).with_suffix(".npy") for f in self.im_files]

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
        for lf in self.label_files:
            cls_list, box_list, seg_list = [], [], []
            if os.path.exists(lf):
                for line in Path(lf).read_text().splitlines():
                    vals = line.split()
                    if not vals:
                        continue
                    c = int(float(vals[0]))
                    coords = np.array(vals[1:], np.float32)
                    if len(coords) == 4:  # box row: cls cx cy w h
                        cls_list.append(c)
                        box_list.append(coords)
                        seg_list.append(np.zeros((0, 2), np.float32))
                    elif len(coords) >= 6 and len(coords) % 2 == 0:  # polygon row
                        pts = coords.reshape(-1, 2)
                        lo, hi = pts.min(0), pts.max(0)
                        cls_list.append(c)
                        box_list.append(
                            np.array([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, hi[0] - lo[0], hi[1] - lo[1]], np.float32)
                        )
                        seg_list.append(pts)
            labels.append({
                "cls": np.array(cls_list, np.int32),
                "bboxes": np.array(box_list, np.float32).reshape(-1, 4),
                "segments": seg_list,
            })
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
        if self.cache_images and self._npy_files[i].exists():
            im = np.load(self._npy_files[i])
            if self.cache_images == "ram":
                self._ram[i] = im
            return im
        im = imread(self.im_files[i])
        if self.cache_images == "ram":
            self._ram[i] = im
        elif self.cache_images == "disk":
            # written under a temporary name and renamed, so that a worker thread reading the same
            # image (the loader repeats the last sample of a padded batch) never sees half a file
            fd, tmp = tempfile.mkstemp(dir=self._npy_files[i].parent, suffix=".npy.tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, im)
            os.replace(tmp, self._npy_files[i])
        return im

    def get_item_raw(self, i: int) -> Dict:
        """One un-augmented sample: BGR image + normalized xywh labels."""
        return {
            "img": self.load_image(i),
            "cls": self.labels[i]["cls"].copy(),
            "bboxes": self.labels[i]["bboxes"].copy(),
            "path": self.im_files[i],
        }
