"""Training and validation transforms (counterpart of `lpc_yolo_tpu/data/augment.py`).

Training (`TrainTransforms`, JAX :415): mosaic-4 (:108) or mosaic-9 (:299,
chosen at :433) with optional mixup of two such canvases (:355),
copy_paste (:367, after mixup), the `random_perspective` warp (:180: affine,
or with `perspective` != 0 cv2.warpPerspective), the HSV jitter (:283) and
the two flips, or the letterbox alone once `close_mosaic` is called
(:442-448). Each sample is split in two steps:

- a host **plan** (`TrainTransforms.plan`): every `np.random.RandomState`
  draw of the JAX transforms, in their order (the mosaic9 and mixup draws
  are taken even when their hyp is 0; there is no albumentations draw, since
  the JAX bridge draws only when that package is installed, :410), the
  geometry of each tile, the copy_paste rectangles, the warp matrix, the
  HSV lookup tables and the flips, and the labels, computed in f64 numpy
  exactly as the JAX package does (box transform, clip, candidate filter);
- a **render** (`render`) of the pixels of a whole batch of plans through
  `cvops`, on any device: the tiles resized with cv2's fixed point straight
  into their canvases (one gather for all tiles of the batch; where tiles
  overlap, as mosaic9's may, the later one wins, as the JAX canvas is
  painted), mixup, copy_paste as one gather (each pasted crop is a mirror
  about the canvas centre, so every pixel reads the canvas at x or at
  w - 1 - x, whichever the chain of pastes over it gives; later pastes read
  what earlier ones wrote, as in the JAX loop), one warp of every canvas
  (the flips folded into its output coordinates), then BGR->HSV, the
  per-sample lookup tables and HSV->BGR.

`TrainTransforms(dataset, idx, rng)` keeps the JAX signature: the plan, then
the render on the CPU. The trainer renders on the card instead. A hyp key
that is not in `DEFAULT_HYP` raises NotImplementedError: no transform reads
it.

Segment training (`SegTrainTransforms`, JAX :506-568) plans the same way,
with the JAX transform's draws (no mosaic9, mixup or copy_paste): polygon labels
resampled to `seg_points` points (`resample_segments` :51, a box row
becomes its rectangle, `_segments_px` :82), carried through mosaic4 (:108)
and the warp (:180-277: warped in f64, divided by w in f64 under
`perspective`, cast to f32, boxes rebuilt from the in-canvas points, the
polygons clipped to them, area_thr 0.01)
and the flips, all on the host in the JAX dtypes; then each instance's
mask is rasterized at imgsz / mask_ratio by `ops/masks.py::fill_poly`
(cv2.fillPoly bit for bit) in the loader's threads, shipped as uint8
(max_gt, imgsz / 4, imgsz / 4). The image is rendered as above.

Pose training (`PoseTrainTransforms`, JAX :571-637) plans the same way,
with the same draws: keypoints (n, K, ndim) f32 in pixels through mosaic4
(:156-164) or the letterbox (:602-608), the warp (:250-261: warped in f64,
divided by w under `perspective`, the points off the canvas marked
invisible from the f64 values, cast back to f32; the boxes from their
corners, area_thr 0.1), then the flips in
f32, fliplr also swapping left and right points by `flip_idx`, and padded
to max_gt. The image is rendered as above.

OBB training (`OBBTrainTransforms`, JAX :640-675) plans the letterbox
(scaleup) and the HSV draw, the JAX transform's only draw: no mosaic, warp
or flip (so `perspective` does not apply). The rotated boxes (`YOLODataset.get_item_raw`, in units of the
frame's longer side s) go through the letterbox in f32 as the JAX
expressions compute them (`x * s * gain + pad`, w and h times s and gain),
padded to max_gt. The plan's warp is the identity on a canvas of the output's
size, which the render's warp passes through unchanged (its images equal
the JAX transform's bit for bit, `tests/test_torch_obb_data.py`).

Validation (`ValTransforms`): the JAX validator letterboxes each frame on the
host with cv2 (`scaleup=False`). The port letterboxes on the card
(`ops/letterbox.py`, the letterbox kernel), so `ValTransforms` hands on the
raw BGR frame with the geometry that letterbox will apply, and the ground
truth in letterbox pixels, padded to `max_gt` rows with a mask.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.letterbox import letterbox_geometry
from ..ops.masks import fill_poly
from ..utils.metrics import box_iou_np
from . import cvops

DEFAULT_HYP = {
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mosaic9": 0.0,
    "mixup": 0.0,
    "copy_paste": 0.0,
}


def xywhn_to_xyxy(bboxes: np.ndarray, w: float, h: float, padw: float = 0, padh: float = 0) -> np.ndarray:
    out = np.empty_like(bboxes)
    out[:, 0] = w * (bboxes[:, 0] - bboxes[:, 2] / 2) + padw
    out[:, 1] = h * (bboxes[:, 1] - bboxes[:, 3] / 2) + padh
    out[:, 2] = w * (bboxes[:, 0] + bboxes[:, 2] / 2) + padw
    out[:, 3] = h * (bboxes[:, 1] + bboxes[:, 3] / 2) + padh
    return out


def resample_segments(segments, n: int = 200) -> np.ndarray:
    """(k, 2) polygons -> (N, n, 2) f32, each closed and resampled by linear interpolation along its
    contour (JAX :51-63); an empty polygon stays zeros."""
    out = np.zeros((len(segments), n, 2), np.float32)
    for i, s in enumerate(segments):
        if len(s) == 0:
            continue
        s = np.concatenate([s, s[0:1]], axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out[i] = np.stack([np.interp(x, xp, s[:, 0]), np.interp(x, xp, s[:, 1])], axis=-1)
    return out


def segments2boxes_px(segments: np.ndarray, width: float, height: float) -> np.ndarray:
    """xyxy f32 boxes of the in-canvas points of each (N, P, 2) polygon; zeros where none is (JAX :66-79)."""
    x, y = segments[..., 0], segments[..., 1]
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    big = np.float32(1e12)
    boxes = np.stack([np.where(inside, x, big).min(axis=1), np.where(inside, y, big).min(axis=1),
                      np.where(inside, x, -big).max(axis=1), np.where(inside, y, -big).max(axis=1)],
                     axis=1).astype(np.float32)
    boxes[~inside.any(axis=1)] = 0.0
    return boxes


def segments_px(item: Dict, boxes_px: np.ndarray, sx: float, sy: float, padx: float, pady: float,
                seg_points: int) -> np.ndarray:
    """An item's normalised polygons -> (n, seg_points, 2) f32 pixel polygons aligned with boxes_px; a
    box row (no polygon) becomes its box's rectangle (JAX `_segments_px` :82-98)."""
    n = len(boxes_px)
    segs = resample_segments(item.get("segments", []), seg_points)
    if len(segs) < n:
        segs = np.concatenate([segs, np.zeros((n - len(segs), seg_points, 2), np.float32)])
    empty = ~segs.reshape(len(segs), -1).any(axis=1) if len(segs) else np.zeros(0, bool)
    segs = segs * np.array([sx, sy], np.float32) + np.array([padx, pady], np.float32)
    if empty.any():
        rect = [resample_segments([np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]], np.float32)],
                                  seg_points)[0] for b in boxes_px[empty]]
        segs[empty] = np.stack(rect)
    return segs


# COCO-17's left/right keypoint swap for the horizontal flip (JAX :105; coco8-pose.yaml's flip_idx)
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def keypoints_px(item: Dict, n: int, kpt_shape: Tuple[int, int], sx: Tuple[float, ...], sy: Tuple[float, ...],
                 padx: float, pady: float) -> np.ndarray:
    """An item's normalised keypoints -> (n, K, ndim) f32 in pixels: x times each factor of `sx` in turn,
    plus padx, in f32 as the JAX expressions compute it (mosaic4 :162 `x * w + padw`, the letterbox :607
    `x * w0 * gain + pad`), the same for y; zeros when the item has none."""
    kpts = item.get("keypoints")
    if kpts is None or kpts.size == 0:
        return np.zeros((n,) + tuple(kpt_shape), np.float32)
    kpts = kpts.copy()
    for axis, factors, pad in ((0, sx, padx), (1, sy, pady)):
        v = kpts[..., axis]
        for f in factors:
            v = v * f
        kpts[..., axis] = v + pad
    return kpts


def check_hyp(hyp: Optional[Dict]) -> None:
    """Refuse a hyp key that no transform reads (the JAX transforms ignore it)."""
    unknown = sorted(set(hyp or {}) - set(DEFAULT_HYP))
    if unknown:
        raise NotImplementedError(f"hyp {unknown} not read by the training transforms; their keys are "
                                  f"{sorted(DEFAULT_HYP)}")


def pad_labels(cls: np.ndarray, boxes: np.ndarray, max_gt: int) -> Dict[str, np.ndarray]:
    """Labels padded (or cut) to `max_gt` rows with a mask."""
    n = min(len(boxes), max_gt)
    out = {"cls": np.zeros((max_gt,), np.int32), "bboxes": np.zeros((max_gt, 4), np.float32),
           "mask": np.zeros((max_gt,), bool)}
    out["bboxes"][:n] = boxes[:n]
    out["cls"][:n] = cls[:n]
    out["mask"][:n] = True
    return out


@dataclasses.dataclass(frozen=True)
class Tile:
    """One source image resized (cv2 INTER_LINEAR) into a rectangle of a canvas."""

    src: int  # dataset index of the source image
    src_hw: Tuple[int, int]
    hw: Tuple[int, int]  # its size after the resize
    rect: Tuple[int, int, int, int]  # x1, y1, x2, y2 on the canvas
    off: Tuple[int, int]  # canvas (x, y) - off = the pixel (u, v) of the resized image


@dataclasses.dataclass(frozen=True)
class Canvas:
    """A canvas filled with 114 and painted with its tiles in order: where tiles overlap, the later wins."""

    hw: Tuple[int, int]
    tiles: Tuple[Tile, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How to render one training sample."""

    canvas: Canvas
    mix: Optional[Canvas]  # mixup's second mosaic, blended before the warp
    mix_r: float
    m: np.ndarray  # (3, 3) forward affine matrix, canvas -> output
    out_hw: Tuple[int, int]
    lut: Optional[np.ndarray]  # (3, 256) uint8 H, S, V tables of the HSV jitter
    flipud: bool
    fliplr: bool
    paste: Optional[np.ndarray] = None  # (P, 4) int64 x1 y1 x2 y2 of copy_paste's crops, in paste order
    perspective: bool = False  # m is a perspective matrix (cv2.warpPerspective)


def mosaic4(dataset, idx: int, rng: np.random.RandomState, imgsz: int, sources: Dict[int, np.ndarray],
            seg_points: Optional[int] = None, kpt_shape: Optional[Tuple[int, int]] = None):
    """The plan of a 4-image mosaic on a 2x2 canvas of side 2 * imgsz (JAX :108-177):
    (Canvas, cls, xyxy boxes clipped to the canvas), and after them with `seg_points` the (n, seg_points, 2)
    f32 polygons, with `kpt_shape` the (n, K, ndim) f32 keypoints, in canvas pixels. Source images go
    into `sources`."""
    s = imgsz
    all_segs, all_kpts = [], []
    yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
    indices = [idx] + [rng.randint(0, len(dataset)) for _ in range(3)]
    tiles, all_cls, all_boxes = [], [], []
    for i, index in enumerate(indices):
        index = int(index)
        item = dataset.get_item_raw(index)
        sources[index] = item["img"]
        h0, w0 = item["img"].shape[:2]
        r = s / max(h0, w0)
        h, w = (int(h0 * r), int(w0 * r)) if r != 1 else (h0, w0)
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b = 0, 0
        padw, padh = x1a - x1b, y1a - y1b
        tiles.append(Tile(index, (h0, w0), (h, w), (x1a, y1a, x2a, y2a), (padw, padh)))
        if len(item["bboxes"]):
            all_boxes.append(xywhn_to_xyxy(item["bboxes"], w, h, padw, padh))
            all_cls.append(item["cls"])
            if seg_points is not None:
                all_segs.append(segments_px(item, all_boxes[-1], w, h, padw, padh, seg_points))
            if kpt_shape is not None:
                all_kpts.append(keypoints_px(item, len(item["bboxes"]), kpt_shape, (w,), (h,), padw, padh))
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls) if all_cls else np.zeros((0,), np.int32)
    out = (Canvas((2 * s, 2 * s), tuple(tiles)), cls, boxes.clip(0, 2 * s))
    if seg_points is not None:
        out += (np.concatenate(all_segs) if all_segs else np.zeros((0, seg_points, 2), np.float32),)
    if kpt_shape is not None:
        out += (np.concatenate(all_kpts) if all_kpts else np.zeros((0,) + tuple(kpt_shape), np.float32),)
    return out


def letterbox_canvas(item: Dict, idx: int, imgsz: int, seg_points: Optional[int] = None,
                     kpt_shape: Optional[Tuple[int, int]] = None):
    """The plan of the host letterbox (`ops/letterbox.py::letterbox_image`, scaleup): one tile,
    resized when its size changes, with the reference's +-0.1 pad split; and the boxes in it (and
    with `seg_points` the polygons, with `kpt_shape` the keypoints)."""
    h0, w0 = item["img"].shape[:2]
    gain, (nw, nh), (dw, dh) = letterbox_geometry((h0, w0), (imgsz, imgsz))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    hw = (top + nh + bottom, left + nw + right)
    tile = Tile(int(idx), (h0, w0), (nh, nw), (left, top, left + nw, top + nh), (left, top))
    boxes = xywhn_to_xyxy(item["bboxes"], w0 * gain, h0 * gain, dw, dh)
    out = (Canvas(hw, (tile,)), boxes)
    if seg_points is not None:
        out += (segments_px(item, boxes, w0 * gain, h0 * gain, dw, dh, seg_points),)
    if kpt_shape is not None:
        out += (keypoints_px(item, len(boxes), kpt_shape, (w0, gain), (h0, gain), dw, dh),)
    return out


def mosaic9(dataset, idx: int, rng: np.random.RandomState, imgsz: int, sources: Dict[int, np.ndarray]):
    """The plan of a 9-image mosaic (JAX :299-352): the tiles laid out on a 3x3 canvas of side 3 * imgsz,
    then its window of side 2 * imgsz at a random (xc, yc): (Canvas of the window, cls, xyxy boxes in it,
    clipped, those 2 px wide and high or less dropped). Tiles may overlap; the later is painted over the
    earlier. Source images go into `sources`."""
    s = imgsz
    indices = [idx] + [rng.randint(0, len(dataset)) for _ in range(8)]
    placed, all_cls, all_boxes = [], [], []
    hp = wp = -1  # the previous tile's size
    for i, index in enumerate(indices):
        index = int(index)
        item = dataset.get_item_raw(index)
        sources[index] = item["img"]
        h0, w0 = item["img"].shape[:2]
        r = s / max(h0, w0)
        h, w = (int(h0 * r), int(w0 * r)) if r != 1 else (h0, w0)
        if i == 0:
            c = s, s, s + w, s + h
        elif i == 1:
            c = s, s - h, s + w, s
        elif i == 2:
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:
            c = s + w0p, s, s + w0p + w, s + h
        elif i == 4:
            c = s + w0p, s + hp, s + w0p + w, s + hp + h
        elif i == 5:
            c = s + w0p - w, s + hp, s + w0p, s + hp + h
        elif i == 6:
            c = s + w0p - wp - w, s + hp, s + w0p - wp, s + hp + h
        elif i == 7:
            c = s - w, s + hp - h, s, s + hp
        else:
            c = s - w, s + hp - hp0 - h, s, s + hp - hp0
        if i == 0:
            w0p, hp0 = w, h
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        placed.append((index, (h0, w0), (h, w), (x1, y1, min(x2, 3 * s), min(y2, 3 * s)), (padw, padh)))
        if len(item["bboxes"]):
            all_boxes.append(xywhn_to_xyxy(item["bboxes"], w, h, padw, padh))
            all_cls.append(item["cls"])
        hp, wp = h, w
    yc, xc = (int(rng.uniform(0, s)) for _ in range(2))  # the window's corner on the 3x3 canvas
    tiles = []
    for index, src_hw, hw, (x1, y1, x2, y2), (padw, padh) in placed:
        rect = (min(max(x1 - xc, 0), 2 * s), min(max(y1 - yc, 0), 2 * s),
                min(max(x2 - xc, 0), 2 * s), min(max(y2 - yc, 0), 2 * s))
        tiles.append(Tile(index, src_hw, hw, rect, (padw - xc, padh - yc)))
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    cls = np.concatenate(all_cls) if all_cls else np.zeros((0,), np.int32)
    boxes = (boxes - np.array([xc, yc, xc, yc], np.float32)).clip(0, 2 * s)
    keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & ((boxes[:, 3] - boxes[:, 1]) > 2)
    return Canvas((2 * s, 2 * s), tuple(tiles)), cls[keep], boxes[keep]


def copy_paste(boxes: np.ndarray, cls: np.ndarray, rng: np.random.RandomState, p: float, w: int):
    """The draws and labels of the JAX box-level copy_paste (:367-385) on a canvas of width w: each drawn box
    whose mirror about the canvas centre overlaps no box by IoU 0.3 or more is mirrored there. Returns
    (boxes, cls) with the pasted ones appended, and the (P, 4) int64 crops x1 y1 x2 y2 in paste order."""
    n = len(boxes)
    if n == 0 or p <= 0:
        return boxes, cls, np.zeros((0, 4), np.int64)
    new_boxes, new_cls, crops = [boxes], [cls], []
    for j in rng.permutation(n)[: round(p * n)]:
        x1, y1, x2, y2 = boxes[j].astype(int)
        box_new = np.array([w - x2, y1, w - x1, y2], np.float32)  # the horizontal mirror
        if (box_iou_np(box_new[None], boxes) < 0.30).all() and x2 > x1 and y2 > y1:
            crops.append((x1, y1, x2, y2))
            new_boxes.append(box_new[None])
            new_cls.append(cls[j: j + 1])
    return np.concatenate(new_boxes), np.concatenate(new_cls), np.array(crops, np.int64).reshape(-1, 4)


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale), in f64 as cv2 computes it."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx = cy = 0.0
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def random_affine(canvas_hw: Tuple[int, int], boxes: np.ndarray, cls: np.ndarray, rng: np.random.RandomState,
                  hyp: Dict, border: Tuple[int, int] = (0, 0), segments: Optional[np.ndarray] = None,
                  keypoints: Optional[np.ndarray] = None):
    """The draws, matrix and label transform of `random_perspective` (JAX :180-280): (M (3, 3), (height,
    width) of the output, boxes, cls), and after them the (n, P, 2) f32 polygons when given (then the boxes
    come from the warped polygons and area_thr is 0.01), and the (n, K, ndim) f32 keypoints when given
    (warped in f64, those off the canvas made invisible). With `perspective` != 0 every warped point is
    divided by its w in f64, as the JAX transform divides it."""
    height = canvas_hw[0] + border[0] * 2
    width = canvas_hw[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -canvas_hw[1] / 2
    C[1, 2] = -canvas_hw[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-hyp["perspective"], hyp["perspective"])
    P[2, 1] = rng.uniform(-hyp["perspective"], hyp["perspective"])
    R = np.eye(3)
    a = rng.uniform(-hyp["degrees"], hyp["degrees"])
    scale = rng.uniform(1 - hyp["scale"], 1 + hyp["scale"])
    R[:2] = rotation_matrix(a, scale)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - hyp["translate"], 0.5 + hyp["translate"]) * width
    T[1, 2] = rng.uniform(0.5 - hyp["translate"], 0.5 + hyp["translate"]) * height
    M = T @ S @ R @ P @ C
    persp = bool(hyp["perspective"])

    def warp(xy):  # (k, 3) homogeneous points -> (k, 2) f64
        xy = xy @ M.T
        return xy[:, :2] / xy[:, 2:3] if persp else xy[:, :2]

    n = len(boxes)
    polys = segments is not None and len(segments)
    if n:
        if polys:  # warp the polygons, boxes from their in-canvas points, polygons clipped to the boxes
            N, P, _ = segments.shape
            xy = np.ones((N * P, 3))
            xy[:, :2] = segments.reshape(N * P, 2)
            segments = warp(xy).reshape(N, P, 2).astype(np.float32)
            new = segments2boxes_px(segments, width, height)
            segments[..., 0] = segments[..., 0].clip(new[:, 0:1], new[:, 2:3])
            segments[..., 1] = segments[..., 1].clip(new[:, 1:2], new[:, 3:4])
        else:
            xy = np.ones((n * 4, 3))
            xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
            xy = warp(xy).reshape(n, 8)
            x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        if keypoints is not None and len(keypoints):  # the visibility from the f64 points (JAX :250-261)
            N, K, ndim = keypoints.shape
            xy = np.ones((N * K, 3))
            xy[:, :2] = keypoints[..., :2].reshape(N * K, 2)
            xy = warp(xy)
            out_of = (xy[:, 0] < 0) | (xy[:, 1] < 0) | (xy[:, 0] > width) | (xy[:, 1] > height)
            keypoints = keypoints.copy()
            keypoints[..., :2] = xy.reshape(N, K, 2)
            if ndim == 3:
                keypoints[..., 2] = np.where(out_of.reshape(N, K), 0.0, keypoints[..., 2])
        # candidate filter (box_candidates): wh > 2 px, aspect < 100, area ratio > 0.1 (0.01 from polygons)
        w1, h1 = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
        w2, h2 = new[:, 2] - new[:, 0], new[:, 3] - new[:, 1]
        ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
        area_thr = 0.01 if polys else 0.10
        keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * scale**2 + 1e-16) > area_thr) & (ar < 100)
        boxes, cls = new[keep], cls[keep]
        if polys:
            segments = segments[keep]
        if keypoints is not None and len(keypoints):
            keypoints = keypoints[keep]
    out = (M, (height, width), boxes, cls)
    if segments is not None:
        out += (segments,)
    if keypoints is not None:
        out += (keypoints,)
    return out


def hsv_tables(rng: np.random.RandomState, hgain: float, sgain: float, vgain: float) -> Optional[np.ndarray]:
    """The draw and the (3, 256) lookup tables of `augment_hsv` (JAX :283-296); None without gains."""
    if not (hgain or sgain or vgain):
        return None
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    x = np.arange(0, 256, dtype=r.dtype)
    return np.stack([((x * r[0]) % 180).astype(np.uint8), np.clip(x * r[1], 0, 255).astype(np.uint8),
                     np.clip(x * r[2], 0, 255).astype(np.uint8)])


class TrainTransforms:
    """Mosaic + affine + HSV + flips -> a fixed (imgsz, imgsz) sample (v8_transforms)."""

    def __init__(self, imgsz: int = 640, hyp: Optional[Dict] = None, max_gt: int = 128):
        self.imgsz = imgsz
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}
        self.max_gt = max_gt
        self.mosaic_enabled = True
        check_hyp(hyp)

    def close_mosaic(self):
        """Disable mosaic for the final epochs."""
        self.mosaic_enabled = False

    def plan(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        """The sample's plan, its source images {dataset index: BGR frame} and its padded labels."""
        hyp, s, sources = self.hyp, self.imgsz, {}
        mix, mix_r = None, 0.0
        paste = None
        if self.mosaic_enabled and rng.rand() < hyp["mosaic"]:
            mfn = mosaic9 if rng.rand() < hyp["mosaic9"] else mosaic4
            canvas, cls, boxes = mfn(dataset, idx, rng, s, sources)
            if rng.rand() < hyp["mixup"]:
                mix, cls2, boxes2 = mfn(dataset, rng.randint(0, len(dataset)), rng, s, sources)
                mix_r = rng.beta(32.0, 32.0)
                cls, boxes = np.concatenate([cls, cls2]), np.concatenate([boxes, boxes2])
            if hyp["copy_paste"] > 0:
                boxes, cls, paste = copy_paste(boxes, cls, rng, hyp["copy_paste"], canvas.hw[1])
            border = (-s // 2, -s // 2)
        else:
            item = dataset.get_item_raw(idx)
            sources[int(idx)] = item["img"]
            canvas, boxes = letterbox_canvas(item, idx, s)
            cls, border = item["cls"], (0, 0)
        m, out_hw, boxes, cls = random_affine(canvas.hw, boxes, cls, rng, hyp, border)
        table = hsv_tables(rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
        flipud = bool(rng.rand() < hyp["flipud"])
        if flipud:
            boxes[:, [1, 3]] = out_hw[0] - boxes[:, [3, 1]]
        fliplr = bool(rng.rand() < hyp["fliplr"])
        if fliplr:
            boxes[:, [0, 2]] = out_hw[1] - boxes[:, [2, 0]]
        plan = Plan(canvas, mix, float(mix_r), m, out_hw, table, flipud, fliplr,
                    paste if paste is not None and len(paste) else None, bool(hyp["perspective"]))
        return {"plan": plan, "sources": sources, **pad_labels(cls, boxes, self.max_gt)}

    def __call__(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        """The JAX transform's output: the plan rendered on the CPU."""
        out = self.plan(dataset, idx, rng)
        img = render([out.pop("plan")], out.pop("sources"), torch.device("cpu"))[0].numpy()
        return {"img": img, **out}


class OBBTrainTransforms(TrainTransforms):
    """Letterbox + HSV -> a fixed (imgsz, imgsz) sample and its rotated boxes (max_gt, 5) [cx, cy, w, h,
    angle] f32 in pixels (JAX `OBBTrainTransforms` :640-675); `bboxes` are zeros, as in the JAX sample."""

    def __init__(self, imgsz: int = 640, hyp: Optional[Dict] = None, max_gt: int = 32):
        self.imgsz, self.max_gt = imgsz, max_gt
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}  # only the HSV gains are read, as in JAX
        self.mosaic_enabled = False
        check_hyp(hyp)

    def plan(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        """The sample's plan, source image, padded labels and (max_gt, 5) f32 rotated boxes."""
        item = dataset.get_item_raw(idx)
        sources = {int(idx): item["img"]}
        canvas, _ = letterbox_canvas(item, idx, self.imgsz)
        h0, w0 = item["img"].shape[:2]
        gain, _, (dw, dh) = letterbox_geometry((h0, w0), (self.imgsz, self.imgsz))
        side = max(h0, w0)
        rb = item.get("rboxes", np.zeros((0, 5), np.float32)).copy()
        rb[:, 0] = rb[:, 0] * side * gain + dw
        rb[:, 1] = rb[:, 1] * side * gain + dh
        rb[:, 2] = rb[:, 2] * side * gain
        rb[:, 3] = rb[:, 3] * side * gain
        table = hsv_tables(rng, self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"])
        n = min(len(rb), self.max_gt)
        out_rb = np.zeros((self.max_gt, 5), np.float32)
        out_rb[:n] = rb[:n]
        plan = Plan(canvas, None, 0.0, np.eye(3), canvas.hw, table, False, False)
        labels = pad_labels(item["cls"], np.zeros((len(rb), 4), np.float32), self.max_gt)
        return {"plan": plan, "sources": sources, **labels, "rboxes": out_rb}


class SegTrainTransforms(TrainTransforms):
    """Mosaic + affine on polygons + HSV + flips -> a fixed (imgsz, imgsz) sample and its instance
    masks at imgsz / mask_ratio (JAX `SegTrainTransforms` :506-568)."""

    def __init__(self, imgsz: int = 640, hyp: Optional[Dict] = None, max_gt: int = 64, mask_ratio: int = 4,
                 seg_points: int = 200):
        self.imgsz, self.max_gt, self.mask_ratio, self.seg_points = imgsz, max_gt, mask_ratio, seg_points
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}  # mosaic9, mixup and copy_paste are not read, as in JAX
        self.mosaic_enabled = True
        check_hyp(hyp)

    def plan(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        """The sample's plan, source images, padded labels and (max_gt, mh, mw) uint8 masks."""
        hyp, s, sources = self.hyp, self.imgsz, {}
        if self.mosaic_enabled and rng.rand() < hyp["mosaic"]:
            canvas, cls, boxes, segs = mosaic4(dataset, idx, rng, s, sources, self.seg_points)
            border = (-s // 2, -s // 2)
        else:
            item = dataset.get_item_raw(idx)
            sources[int(idx)] = item["img"]
            canvas, boxes, segs = letterbox_canvas(item, idx, s, self.seg_points)
            cls, border = item["cls"], (0, 0)
        m, out_hw, boxes, cls, segs = random_affine(canvas.hw, boxes, cls, rng, hyp, border, segments=segs)
        table = hsv_tables(rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
        flipud = bool(rng.rand() < hyp["flipud"])
        if flipud:
            boxes[:, [1, 3]] = out_hw[0] - boxes[:, [3, 1]]
            segs[..., 1] = out_hw[0] - segs[..., 1]
        fliplr = bool(rng.rand() < hyp["fliplr"])
        if fliplr:
            boxes[:, [0, 2]] = out_hw[1] - boxes[:, [2, 0]]
            segs[..., 0] = out_hw[1] - segs[..., 0]
        mh = mw = s // self.mask_ratio
        n = min(len(boxes), self.max_gt)
        masks = np.zeros((self.max_gt, mh, mw), np.uint8)
        r = 1.0 / self.mask_ratio
        for j in range(n):
            fill_poly(masks[j], (segs[j] * r).astype(np.int32))
        plan = Plan(canvas, None, 0.0, m, out_hw, table, flipud, fliplr, perspective=bool(hyp["perspective"]))
        return {"plan": plan, "sources": sources, **pad_labels(cls, boxes, self.max_gt), "masks": masks}


class PoseTrainTransforms(TrainTransforms):
    """Mosaic + affine on keypoints + HSV + flips (fliplr with the left/right `flip_idx` swap) -> a fixed
    (imgsz, imgsz) sample and its keypoints (max_gt, K, ndim) f32 in pixels (JAX `PoseTrainTransforms`
    :571-637). `flip_idx` defaults to COCO's for K == 17 and to the identity otherwise."""

    def __init__(self, imgsz: int = 640, hyp: Optional[Dict] = None, max_gt: int = 32,
                 kpt_shape: Tuple[int, int] = (17, 3), flip_idx: Optional[List[int]] = None):
        self.imgsz, self.max_gt, self.kpt_shape = imgsz, max_gt, tuple(kpt_shape)
        self.hyp = {**DEFAULT_HYP, **(hyp or {})}  # mosaic9, mixup and copy_paste are not read, as in JAX
        if flip_idx is None:
            flip_idx = COCO_FLIP_IDX if self.kpt_shape[0] == 17 else list(range(self.kpt_shape[0]))
        self.flip_idx = list(flip_idx)
        self.mosaic_enabled = True
        check_hyp(hyp)

    def plan(self, dataset, idx: int, rng: np.random.RandomState) -> Dict:
        """The sample's plan, source images, padded labels and (max_gt, K, ndim) f32 keypoints."""
        hyp, s, sources = self.hyp, self.imgsz, {}
        if self.mosaic_enabled and rng.rand() < hyp["mosaic"]:
            canvas, cls, boxes, kpts = mosaic4(dataset, idx, rng, s, sources, kpt_shape=self.kpt_shape)
            border = (-s // 2, -s // 2)
        else:
            item = dataset.get_item_raw(idx)
            sources[int(idx)] = item["img"]
            canvas, boxes, kpts = letterbox_canvas(item, idx, s, kpt_shape=self.kpt_shape)
            cls, border = item["cls"], (0, 0)
        m, out_hw, boxes, cls, kpts = random_affine(canvas.hw, boxes, cls, rng, hyp, border, keypoints=kpts)
        table = hsv_tables(rng, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
        flipud = bool(rng.rand() < hyp["flipud"])
        if flipud:
            boxes[:, [1, 3]] = out_hw[0] - boxes[:, [3, 1]]
            kpts[..., 1] = out_hw[0] - kpts[..., 1]
        fliplr = bool(rng.rand() < hyp["fliplr"])
        if fliplr:
            boxes[:, [0, 2]] = out_hw[1] - boxes[:, [2, 0]]
            kpts[..., 0] = out_hw[1] - kpts[..., 0]
            kpts = kpts[:, self.flip_idx]
        out_kpts = np.zeros((self.max_gt,) + self.kpt_shape, np.float32)
        n = min(len(boxes), self.max_gt)
        if len(kpts):
            out_kpts[:n] = kpts[:n]
        plan = Plan(canvas, None, 0.0, m, out_hw, table, flipud, fliplr, perspective=bool(hyp["perspective"]))
        return {"plan": plan, "sources": sources, **pad_labels(cls, boxes, self.max_gt), "keypoints": out_kpts}


@functools.lru_cache(maxsize=256)
def _resize_taps(src_hw: Tuple[int, int], hw: Tuple[int, int]):
    taps = cvops.resize_taps(src_hw, hw)
    for t in taps:
        t.flags.writeable = False  # shared by every caller of the cache
    return taps


def source_pool(sources: Dict[int, np.ndarray], device: torch.device) -> Tuple[torch.Tensor, Dict[int, int]]:
    """All source frames in one flat (P, 3) uint8 tensor on `device` (one copy, from pinned
    memory on the card) and each frame's first pixel in it."""
    keys = sorted(sources)
    sizes = [sources[k].size for k in keys]
    host = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=device.type == "cuda")
    view, base, o = host.numpy(), {}, 0
    for k, n in zip(keys, sizes):
        view[o:o + n] = np.ascontiguousarray(sources[k]).reshape(-1)
        base[k] = o // 3
        o += n
    return host.to(device, non_blocking=True).view(-1, 3), base


def _canvas_tables(canvases: List[Canvas], base: Dict[int, int], hc: int, wc: int, k: int):
    """Per canvas and tile slot, the tile's taps along each canvas column (inside, c0, c1, a0, a1)
    and row (inside, pool offset of row 0 and row 1, b0, b1): int32 (C * k * Wc, 5), (C * k * Hc, 5)."""
    cols = np.zeros((len(canvases), k, wc, 5), np.int32)
    rows = np.zeros((len(canvases), k, hc, 5), np.int32)
    for ci, cv in enumerate(canvases):
        for j, t in enumerate(cv.tiles):
            x1, y1, x2, y2 = t.rect
            if x2 <= x1 or y2 <= y1:
                continue
            ry, rx = _resize_taps(t.src_hw, t.hw)
            u = np.arange(x1, x2) - t.off[0]
            v = np.arange(y1, y2) - t.off[1]
            cols[ci, j, x1:x2] = np.stack([np.ones_like(u), rx[0][u], rx[1][u], rx[2][u], rx[3][u]], -1)
            w0, b = t.src_hw[1], base[t.src]
            rows[ci, j, y1:y2] = np.stack([np.ones_like(v), b + ry[0][v] * w0, b + ry[1][v] * w0, ry[2][v], ry[3][v]],
                                          -1)
    return cols.reshape(-1, 5), rows.reshape(-1, 5)


def _grid(edges_x: List[np.ndarray], edges_y: List[np.ndarray]):
    """Sorted cell edges of several grids padded to one width (with a value past every pixel):
    (C, Ex) and (C, Ey) int64."""
    ex, ey = max(len(e) for e in edges_x), max(len(e) for e in edges_y)
    gx, gy = np.full((len(edges_x), ex), 1 << 40, np.int64), np.full((len(edges_y), ey), 1 << 40, np.int64)
    for i, (a, b) in enumerate(zip(edges_x, edges_y)):
        gx[i, :len(a)], gy[i, :len(b)] = a, b
    return gx, gy


def _owner_grid(canvases: List[Canvas]):
    """The tile painted last over each cell of the grid that its canvas's tile edges cut: (C, Ex) x edges,
    (C, Ey) y edges, (C, Ey, Ex) int64 tile slot (-1 where no tile lies)."""
    ex, ey = [], []
    for cv in canvases:
        ex.append(np.unique([0] + [v for t in cv.tiles for v in (t.rect[0], t.rect[2])]))
        ey.append(np.unique([0] + [v for t in cv.tiles for v in (t.rect[1], t.rect[3])]))
    gx, gy = _grid(ex, ey)
    owner = np.full((len(canvases), gy.shape[1], gx.shape[1]), -1, np.int64)
    for ci, cv in enumerate(canvases):
        for j, t in enumerate(cv.tiles):  # in painting order: a later tile covers an earlier one
            x1, y1, x2, y2 = t.rect
            owner[ci][np.ix_((gy[ci] >= y1) & (gy[ci] < y2), (gx[ci] >= x1) & (gx[ci] < x2))] = j
    return gx, gy, owner


def _paste_grid(plans: List[Plan]):
    """copy_paste as a per-pixel choice: each paste writes its crop (x1, y1, x2, y2) mirrored to
    [w - x2, w - x1), so pixel (x, y) of the pasted canvas reads the canvas before the pastes at x or at
    w - 1 - x. Walking the pastes from the last back to the first decides which; the answer is constant
    on the cells that the crops' edges and their mirrors cut. Returns (B, Ex) x edges, (B, Ey) y edges and
    (B, Ey, Ex) bool, True where the pixel reads w - 1 - x."""
    ex, ey = [], []
    for p in plans:
        w = p.canvas.hw[1]
        x1, y1, x2, y2 = p.paste.T
        ex.append(np.unique(np.concatenate([[0], x1, x2, w - x2, w - x1])))
        ey.append(np.unique(np.concatenate([[0], y1, y2])))
    gx, gy = _grid(ex, ey)
    mirror = np.zeros((len(plans), gy.shape[1], gx.shape[1]), bool)
    for i, p in enumerate(plans):
        w = p.canvas.hw[1]
        X, Y = gx[i][None, :], gy[i][:, None]
        xcur = np.broadcast_to(X, mirror.shape[1:]).copy()
        for x1, y1, x2, y2 in p.paste[::-1]:
            hit = (xcur >= w - x2) & (xcur < w - x1) & (Y >= y1) & (Y < y2)
            xcur = np.where(hit, w - 1 - xcur, xcur)
        mirror[i] = xcur != X
    return gx, gy, mirror


def _cell_lookup(table: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """table (N, Ey, Ex) read at every pixel of (hc, wc) through the grids' edges -> (N, hc, wc)."""
    dev = table.device
    n, ey, ex = table.shape
    x = torch.arange(wc, device=dev).expand(n, wc).contiguous()
    y = torch.arange(hc, device=dev).expand(n, hc).contiguous()
    cx = torch.searchsorted(gx, x, right=True) - 1
    cy = torch.searchsorted(gy, y, right=True) - 1
    idx = (torch.arange(n, device=dev)[:, None, None] * ey + cy[:, :, None]) * ex + cx[:, None, :]
    return table.reshape(-1)[idx]


def render(plans: List[Plan], sources: Dict[int, np.ndarray], device: torch.device) -> torch.Tensor:
    """Render a batch of plans on `device`: (B, H, W, 3) uint8 BGR.

    Launches do not grow with the batch: one gather resizes every tile of every
    canvas, one gather makes every copy_paste, one warp covers the batch, the
    HSV jitter runs once on it.
    """
    B = len(plans)
    out_hw = plans[0].out_hw
    if any(p.out_hw != out_hw for p in plans):
        raise ValueError("the plans of one batch must share their output size")
    if len({p.perspective for p in plans}) > 1:
        raise ValueError("the plans of one batch must all or none warp in perspective")
    pool3, base = source_pool(sources, device)
    mix_rows = [i for i, p in enumerate(plans) if p.mix is not None]
    canvases = [p.canvas for p in plans] + [plans[i].mix for i in mix_rows]
    C, K = len(canvases), max(len(c.tiles) for c in canvases)
    hc, wc = max(c.hw[0] for c in canvases), max(c.hw[1] for c in canvases)
    to = lambda a: torch.from_numpy(a).to(device, non_blocking=True)  # noqa: E731
    cols, rows = (to(t) for t in _canvas_tables(canvases, base, hc, wc, K))
    gx, gy, owner = (to(t) for t in _owner_grid(canvases))

    # every canvas pixel: the tile painted last over it, then cv2's fixed-point resize of that tile
    x = torch.arange(wc, device=device)
    y = torch.arange(hc, device=device)
    own = _cell_lookup(owner, gx, gy, hc, wc)
    slot = torch.arange(C, device=device)[:, None, None] * K + own.clamp(min=0)
    cv = cols.index_select(0, (slot * wc + x).reshape(-1)).view(C, hc, wc, 5)
    rv = rows.index_select(0, (slot * hc + y[:, None]).reshape(-1)).view(C, hc, wc, 5)
    val = cvops.fixed_bilinear(pool3, rv[..., 1], rv[..., 2], rv[..., 3], rv[..., 4],
                               cv[..., 1], cv[..., 2], cv[..., 3], cv[..., 4])
    canvas = torch.where((own >= 0)[..., None], val, cvops.BORDER).to(torch.uint8)
    del cv, rv, val, own, slot
    if mix_rows:
        ia = torch.tensor(mix_rows, device=device)
        canvas[ia] = cvops.blend(canvas[ia], canvas[B:], [plans[i].mix_r for i in mix_rows])

    paste_rows = [i for i, p in enumerate(plans) if p.paste is not None]
    if paste_rows:  # copy_paste, after mixup (JAX :439-440): one gather of the pasted canvases
        gx, gy, mirror = (to(t) for t in _paste_grid([plans[i] for i in paste_rows]))
        flip = _cell_lookup(mirror, gx, gy, hc, wc)
        ip = torch.tensor(paste_rows, device=device)
        w = torch.tensor([plans[i].canvas.hw[1] for i in paste_rows], device=device)[:, None, None]
        src_x = torch.where(flip, w - 1 - x, x)
        idx = (ip[:, None, None] * hc + y[:, None]) * wc + src_x
        canvas[ip] = canvas.view(-1, 3).index_select(0, idx.reshape(-1)).view(len(paste_rows), hc, wc, 3)

    # one warp of the batch, the flips folded into its output coordinates
    if plans[0].perspective:
        minv = np.stack([cvops.invert_perspective(p.m) for p in plans]).astype(np.float32)
    else:
        minv = np.stack([cvops.invert_affine(p.m[:2]) for p in plans]).astype(np.float32)
    ext = torch.tensor([p.canvas.hw for p in plans], device=device)
    flips = torch.tensor([[p.flipud, p.fliplr] for p in plans], device=device)
    img = cvops.warp_core(canvas.view(-1, 3), torch.arange(B, device=device) * (hc * wc),
                          torch.full((B,), wc, device=device), ext[:, 0], ext[:, 1],
                          torch.from_numpy(minv).to(device), out_hw, flips[:, 0], flips[:, 1])
    tables = [p.lut for p in plans]
    if any(t is not None for t in tables):
        if any(t is None for t in tables):
            raise ValueError("the plans of one batch must all or none have HSV tables")
        luts = torch.from_numpy(np.stack(tables)).to(device, non_blocking=True)
        img = cvops.hsv2bgr(cvops.lut(cvops.bgr2hsv(img), luts))
    return img


class ValTransforms:
    """The raw frame, the letterbox geometry for unscaling, and the padded ground truth; for an oriented set
    also its rotated boxes (max_gt, 5) in letterbox pixels, in the JAX validator's f32 arithmetic (`x * (s
    * gain) + pad`, :188-200, with s the frame's longer side where the JAX package takes w0 for x and w, h0
    for y and h)."""

    def __init__(self, imgsz: int = 640, max_gt: int = 128):
        self.imgsz = imgsz
        self.max_gt = max_gt

    def __call__(self, dataset, idx: int, rng=None) -> Dict:
        item = dataset.get_item_raw(idx)
        img0 = item["img"]
        h0, w0 = img0.shape[:2]
        gain, _, pad = letterbox_geometry((h0, w0), (self.imgsz, self.imgsz), scaleup=False)
        boxes = xywhn_to_xyxy(item["bboxes"], w0 * gain, h0 * gain, pad[0], pad[1])
        out = {
            "img": img0,
            **pad_labels(item["cls"], boxes, self.max_gt),
            "orig_shape": (h0, w0),
            "gain": gain,
            "pad": pad,
            "path": item["path"],
        }
        if "rboxes" in item:
            rb, f = item["rboxes"].copy(), max(h0, w0) * gain
            rb[:, 0] = rb[:, 0] * f + float(pad[0])
            rb[:, 1] = rb[:, 1] * f + float(pad[1])
            rb[:, 2:4] *= f
            n = min(len(rb), self.max_gt)
            out["rboxes"] = np.zeros((self.max_gt, 5), np.float32)
            out["rboxes"][:n] = rb[:n]
        return out
