"""Drawing on frames (counterpart of `lpc_yolo_tpu/utils/plotting.py:146-303`: `Colors`, `colors`,
`Annotator` and `save_one_box`).

These draw with cv2's anti-aliased lines, circles and Hershey text, and write
with `cv2.imwrite`; nothing written here could match those pixels, so cv2 is
imported lazily where they draw or write (`utils.require_cv2`), and without it
they raise an ImportError that names the feature. The palette, the label
geometry, the mask blend (in numpy) and the crop box are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from . import require_cv2


class Colors:
    """The Ultralytics palette: `colors(i, bgr=True)` is class i's colour."""

    HEXS = (
        "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
        "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
        "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
    )
    POSE = np.array(
        [
            [255, 128, 0], [255, 153, 51], [255, 178, 102], [230, 230, 0],
            [255, 153, 255], [153, 204, 255], [255, 102, 255], [255, 51, 255],
            [102, 178, 255], [51, 153, 255], [255, 153, 153], [255, 102, 102],
            [255, 51, 51], [153, 255, 153], [102, 255, 102], [51, 255, 51],
            [0, 255, 0], [0, 0, 255], [255, 0, 0], [255, 255, 255],
        ],
        dtype=np.uint8,
    )

    def __init__(self):
        self.palette = [tuple(int(h[i:i + 2], 16) for i in (0, 2, 4)) for h in self.HEXS]
        self.n = len(self.palette)

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()

# COCO's 17-keypoint skeleton
SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]
LIMB_COLOR_IDX = [9, 9, 9, 9, 7, 7, 7, 0, 0, 0, 0, 0, 16, 16, 16, 16, 16, 16, 16]
KPT_COLOR_IDX = [16, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 9, 9, 9, 9, 9, 9]


class Annotator:
    """Draws on an HWC uint8 BGR frame: boxes with filled labels, rotated polygons, alpha-blended masks,
    keypoints with COCO's skeleton, text."""

    def __init__(self, im: np.ndarray, line_width: Optional[int] = None):
        self.im = im if im.flags.writeable else im.copy()
        self.lw = line_width or max(round(sum(im.shape) / 2 * 0.003), 2)
        self.tf = max(self.lw - 1, 1)  # text thickness
        self.sf = self.lw / 3  # text scale

    def box_label(self, box, label: str = "", color=(128, 128, 128), txt_color=(255, 255, 255), rotated: bool = False):
        """One xyxy box (or a 4x2 polygon when rotated) and its label on a filled background."""
        cv2 = require_cv2("drawing a box")
        if rotated:
            pts = np.asarray(box, dtype=int).reshape(-1, 2)
            cv2.polylines(self.im, [pts], True, color, self.lw)
            p1 = tuple(pts[0])
        else:
            p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
            cv2.rectangle(self.im, p1, p2, color, thickness=self.lw, lineType=cv2.LINE_AA)
        if label:
            w, h = cv2.getTextSize(label, 0, fontScale=self.sf, thickness=self.tf)[0]
            outside = p1[1] - h >= 3
            p2 = p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3
            cv2.rectangle(self.im, p1, p2, color, -1, cv2.LINE_AA)
            cv2.putText(
                self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2),
                0, self.sf, txt_color, thickness=self.tf, lineType=cv2.LINE_AA,
            )

    def masks(self, masks: np.ndarray, mask_colors, alpha: float = 0.5):
        """Blend (n, h, w) masks over the frame, each in its colour at `alpha`, the later ones over the
        earlier (a cumulative product of (1 - alpha)); masks of another size are resized to the frame."""
        cv2 = require_cv2("drawing masks")
        if len(masks) == 0:
            return
        h, w = self.im.shape[:2]
        m = np.stack(
            [cv2.resize(mk.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR) for mk in masks]
        )
        m = (m > 0.5).astype(np.float32)[..., None]  # (n, h, w, 1)
        cols = np.asarray(mask_colors, np.float32)[:, None, None] / 255.0  # (n, 1, 1, 3)
        masks_color = m * (cols * alpha)
        inv_alpha = np.cumprod(1 - m * alpha, axis=0)
        mcs = masks_color.max(axis=0)
        im01 = self.im.astype(np.float32) / 255.0
        out = im01 * inv_alpha[-1] + mcs
        self.im[:] = (out * 255).astype(np.uint8)

    def kpts(self, kpts: np.ndarray, radius: int = 5, kpt_line: bool = True, conf_thres: float = 0.5):
        """Keypoints (K, 2|3) in frame pixels, with COCO's skeleton when K is 17."""
        cv2 = require_cv2("drawing keypoints")
        nkpt, ndim = kpts.shape
        is_pose = nkpt == 17 and ndim in (2, 3)
        kpt_line &= is_pose
        h, w = self.im.shape[:2]
        for i, k in enumerate(kpts):
            if ndim == 3 and k[2] < conf_thres:
                continue
            x, y = int(k[0]), int(k[1])
            if 0 < x < w and 0 < y < h:
                ck = tuple(int(v) for v in Colors.POSE[KPT_COLOR_IDX[i]]) if is_pose else colors(i)
                cv2.circle(self.im, (x, y), radius, ck, -1, lineType=cv2.LINE_AA)
        if kpt_line:
            for i, (a, b) in enumerate(SKELETON):
                ka, kb = kpts[a - 1], kpts[b - 1]
                if ndim == 3 and (ka[2] < conf_thres or kb[2] < conf_thres):
                    continue
                p1, p2 = (int(ka[0]), int(ka[1])), (int(kb[0]), int(kb[1]))
                if not (0 < p1[0] < w and 0 < p1[1] < h and 0 < p2[0] < w and 0 < p2[1] < h):
                    continue
                cl = tuple(int(v) for v in Colors.POSE[LIMB_COLOR_IDX[i]])
                cv2.line(self.im, p1, p2, cl, thickness=2, lineType=cv2.LINE_AA)

    def text(self, xy, label: str, txt_color=(255, 255, 255)):
        cv2 = require_cv2("drawing text")
        cv2.putText(self.im, label, (int(xy[0]), int(xy[1])), 0, self.sf, txt_color,
                    thickness=self.tf, lineType=cv2.LINE_AA)

    def result(self) -> np.ndarray:
        return self.im


def save_one_box(xyxy, im: np.ndarray, file="im.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, save: bool = True) -> np.ndarray:
    """The crop of an xyxy box from a BGR frame, the box grown by `gain` and `pad` pixels and clipped to
    the frame; with `save`, written to `file` (stem1, stem2, ... when it exists). Returns the crop."""
    b = np.asarray(xyxy, np.float32).reshape(4)
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    w, h = (b[2] - b[0]) * gain + pad, (b[3] - b[1]) * gain + pad
    if square:
        w = h = max(w, h)
    x1 = int(max(0, cx - w / 2))
    y1 = int(max(0, cy - h / 2))
    x2 = int(min(im.shape[1], cx + w / 2))
    y2 = int(min(im.shape[0], cy + h / 2))
    crop = im[y1:y2, x1:x2]
    if save:
        cv2 = require_cv2("saving a crop")
        f = Path(file)
        f.parent.mkdir(parents=True, exist_ok=True)
        out, i = f, 1
        while out.exists():
            out = f.with_name(f"{f.stem}{i}{f.suffix}")
            i += 1
        cv2.imwrite(str(out), crop)
    return crop
