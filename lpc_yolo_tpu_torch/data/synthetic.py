"""Synthetic YOLO-format dataset: coloured rectangles on noise, boxes exactly known, and a class-folder set
(counterpart of `lpc_yolo_tpu/data/synthetic.py::make_synthetic_dataset`).

Written without OpenCV: each frame is a PNG (zlib, standard library) with its
decoded BGR array as a `.npy` twin beside it, which `cache_images="disk"`
reads on a machine without OpenCV. With the default square frames the
`np.random.RandomState` draws, the arrays and the label files are those of
the JAX package (which writes JPEGs through cv2); PNG keeps the pixels exact,
so both packages read the same frames.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import yaml

COLORS = [(60, 60, 220), (60, 220, 60), (220, 60, 60), (40, 200, 220), (220, 200, 40)]


def write_png(path, bgr: np.ndarray) -> None:
    """An 8-bit RGB PNG of an HWC uint8 BGR frame, written with zlib and struct."""
    h, w, _ = bgr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), bgr[..., ::-1].reshape(h, w * 3)], axis=1)  # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def make_synthetic_dataset(root, n_train: int = 8, n_val: int = 4, imgsz: int = 160, nc: int = 3,
                           max_boxes: int = 4, seed: int = 0,
                           shapes: Optional[Sequence[Tuple[int, int]]] = None, segments: bool = False) -> str:
    """Create images/{train,val} (PNG + .npy) + labels/{train,val} + data.yaml; returns the yaml path.

    shapes: (h, w) of the frames, cycled over each split; None gives the JAX
    package's square imgsz frames. Each frame holds 1 to max_boxes rectangles.
    segments: label each rectangle by its four corners as a YOLO-seg polygon
    row instead of a box row (JAX :44-50).
    """
    rng = np.random.RandomState(seed)
    root = Path(root)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = shapes[i % len(shapes)] if shapes else (imgsz, imgsz)
            img = rng.randint(90, 140, (h, w, 3), np.uint8)
            rows = []
            for _ in range(rng.randint(1, max_boxes + 1)):
                c = rng.randint(0, nc)
                if h == w:  # the JAX package's draws
                    bw, bh = rng.randint(h // 6, h // 2, 2)
                else:
                    bw, bh = rng.randint(w // 6, w // 2), rng.randint(h // 6, h // 2)
                x1 = rng.randint(0, w - bw)
                y1 = rng.randint(0, h - bh)
                img[y1:y1 + bh + 1, x1:x1 + bw + 1] = COLORS[c % len(COLORS)]  # cv2.rectangle, filled
                if segments:
                    pts = ((x1 / w, y1 / h), ((x1 + bw) / w, y1 / h), ((x1 + bw) / w, (y1 + bh) / h),
                           (x1 / w, (y1 + bh) / h))
                    rows.append(f"{c} " + " ".join(f"{a:.6f} {b:.6f}" for a, b in pts))
                else:
                    rows.append(f"{c} {(x1 + bw / 2) / w:.6f} {(y1 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
            f = root / "images" / split / f"im{i:03d}.png"
            write_png(f, img)
            np.save(f.with_suffix(".npy"), img)
            (root / "labels" / split / f"im{i:03d}.txt").write_text("\n".join(rows) + "\n")
    data = {
        "path": str(root),
        "train": "images/train",
        "val": "images/val",
        "nc": nc,
        "names": {i: f"class{i}" for i in range(nc)},
    }
    yaml_path = root / "data.yaml"
    yaml_path.write_text(yaml.safe_dump(data))
    return str(yaml_path)


def make_cls_dataset(root, n_train: int = 6, n_val: int = 4, nc: int = 2,
                     shapes: Sequence[Tuple[int, int]] = ((64, 64),), seed: int = 0,
                     skip_val: Sequence[int] = ()) -> str:
    """A class-folder set, `{train,val}/class<k>/<i>.png` (+ `.npy` twins): each frame class k's colour
    plus uniform noise in [-20, 20), as the JAX package's class-folder test set (`tests/test_tasks.py:129-143`);
    `shapes` (h, w) cycle over each split's frames. `skip_val`: classes the val split lacks. Returns the root."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    for split, n in (("train", n_train), ("val", n_val)):
        for k in range(nc):
            if split == "val" and k in skip_val:
                continue
            d = root / split / f"class{k}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n):
                h, w = shapes[i % len(shapes)]
                img = np.clip(np.full((h, w, 3), COLORS[k % len(COLORS)], np.int16)
                              + rng.randint(-20, 20, (h, w, 3)), 0, 255).astype(np.uint8)
                write_png(d / f"{i}.png", img)
                np.save(d / f"{i}.npy", img)
    return str(root)
