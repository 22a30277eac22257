"""Classification data: the folder-per-class layout, its dataset and transforms.

Counterpart of `lpc_yolo_tpu/data/classify.py` (`check_cls_dataset` :19-34,
`ClassificationDataset` :37-68, `ClsTransforms` :71-85): a root holds
`{train,val,test}/<class>/<image>`; a sample is one image and its class index;
the transform resizes the frame to a square `imgsz` with cv2's INTER_LINEAR
(`data/cvops.py::resize`, cv2's arithmetic bit for bit, on the host tensor)
and, when augmenting, flips it left-right on the sample's `rng.rand()` draw,
as the JAX transform does. Images are read as the detection sets' are
(`data/dataset.py::read_image`): with `cache_images` from their `.npy` twins,
which a machine without OpenCV needs.

One difference: with `names` (the dataset's, from `check_cls_dataset`) a
sample's label is its folder's index in `names`. The JAX dataset always
numbers the split's own folders, so a val split that lacks one of train's
classes shifts the labels of every later class (ROADMAP Queue 3); where both
splits hold every class the two agree.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .cvops import resize
from .dataset import IMG_SUFFIXES, read_image


def check_cls_dataset(root: Union[str, Path]) -> Dict:
    """Resolve a classification dataset root: its split directories, and the class names and count from
    the first split (train, val, test) that exists."""
    root = Path(root)
    out: Dict = {"path": str(root)}
    names: List[str] = []
    for split in ("train", "val", "test"):
        d = root / split
        if d.is_dir():
            out[split] = str(d)
            if not names:
                names = sorted(p.name for p in d.iterdir() if p.is_dir())
    if not names:
        raise FileNotFoundError(f"no class folders under {root}/{{train,val,test}}")
    out["names"] = dict(enumerate(names))
    out["nc"] = len(names)
    return out


class ClassificationDataset:
    """The images of one split, class folder by class folder in sorted order, each folder's files sorted."""

    def __init__(self, split_dir: Union[str, Path], imgsz: int = 224, names: Optional[Dict[int, str]] = None,
                 cache_images: Union[bool, str] = False):
        self.root = Path(split_dir)
        self.imgsz = imgsz
        self.cache_images = "ram" if cache_images is True else (cache_images or None)
        classes = sorted(p.name for p in self.root.iterdir() if p.is_dir())
        self.names = names or dict(enumerate(classes))
        self.class_to_idx = {c: i for i, c in self.names.items()}
        unknown = [c for c in classes if c not in self.class_to_idx]
        if unknown:
            raise ValueError(f"class folders {unknown} of {self.root} are not among the dataset's names")
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            for f in sorted((self.root / c).rglob("*")):
                if f.suffix.lower() in IMG_SUFFIXES:
                    self.samples.append((str(f), self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {self.root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load_image(self, i: int) -> np.ndarray:
        return read_image(self.samples[i][0], self.cache_images)

    def get_item_raw(self, i: int) -> Dict:
        return {"img": self.load_image(i), "label": self.samples[i][1], "path": self.samples[i][0]}


class ClsTransforms:
    """Square resize (and the left-right flip when augmenting) -> {'img' uint8 BGR (imgsz, imgsz, 3), 'label'
    int32}."""

    def __init__(self, imgsz: int = 224, augment: bool = False, fliplr: float = 0.5):
        self.imgsz = imgsz
        self.augment = augment
        self.fliplr = fliplr

    def __call__(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        item = dataset.get_item_raw(idx)
        img = resize(torch.from_numpy(np.ascontiguousarray(item["img"]))[None], (self.imgsz, self.imgsz))[0].numpy()
        if self.augment and rng.rand() < self.fliplr:
            img = np.ascontiguousarray(img[:, ::-1])
        return {"img": img, "label": np.int32(item["label"])}
