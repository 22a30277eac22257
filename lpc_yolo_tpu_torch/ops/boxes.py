"""Box conversions and IoU (counterpart of `lpc_yolo_tpu/ops/boxes.py`
xywh2xyxy :19, bbox_iou :72, probiou :145, xywhr2xyxyxyxy :164, scale_boxes
:174, clip_boxes :195, rbox_hull :203, regularize_rboxes :267; reference ops.py, metrics.py)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

EPS = 1e-7


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w / 2, h / 2
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False, CIoU: bool = False,
             eps: float = EPS) -> torch.Tensor:
    """Elementwise IoU (or GIoU, or CIoU) of aligned boxes, broadcasting; last axis = 4.

    Returns the broadcast shape with a trailing singleton axis. In CIoU the
    trade-off weight `alpha` is a constant of the gradient (detached), and the
    xyxy heights carry `+ eps` as in the reference (metrics.py:78). GIoU is
    IoU - (C - union) / C with C the enclosing box's area + eps (JAX :116-117).
    """
    if xywh:
        x1, y1, w1, h1 = box1.split(1, -1)
        x2, y2, w2, h2 = box2.split(1, -1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.split(1, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.split(1, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)
    ).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or CIoU):
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
    if not CIoU:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps  # convex diagonal squared
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def clip_boxes(boxes: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Clip xyxy boxes to an image of shape (h, w)."""
    x = boxes[..., 0::2].clamp(0, shape[1])
    y = boxes[..., 1::2].clamp(0, shape[0])
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None, padding: bool = True) -> torch.Tensor:
    """Rescale xyxy boxes from the letterboxed img1_shape (h, w) back to img0_shape."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
            round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1),
        )
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    if padding:
        boxes = boxes - torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def _rbox_covariance(obb: torch.Tensor):
    """The Gaussian covariance terms (a, b, c) of rotated boxes [cx, cy, w, h, angle] (JAX :134-140)."""
    w, h, r = obb[..., 2], obb[..., 3], obb[..., 4]
    a, b = w ** 2 / 12.0, h ** 2 / 12.0
    cos, sin = torch.cos(r), torch.sin(r)
    return a * cos ** 2 + b * sin ** 2, a * sin ** 2 + b * cos ** 2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Probabilistic IoU of rotated boxes (..., 5) [cx, cy, w, h, angle], elementwise with broadcasting ->
    (...,) in [0, 1], in the JAX order of operations (:145-161): the Bhattacharyya distance clipped to
    [eps, 100], then 1 - sqrt(1 - exp(-bd) + eps)."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _rbox_covariance(obb1)
    a2, b2, c2 = _rbox_covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    det1 = (a1 * b1 - c1 ** 2).clamp(min=0)
    det2 = (a2 * b2 - c2 ** 2).clamp(min=0)
    t3 = torch.log(denom / (4 * torch.sqrt(det1 * det2) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)


def xywhr2xyxyxyxy(rbox: torch.Tensor) -> torch.Tensor:
    """Rotated boxes (..., 5) -> their corners (..., 4, 2): ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2,
    ctr - v1 + v2 with v1 = w/2 (cos, sin), v2 = h/2 (-sin, cos) (JAX :164-171)."""
    c, s = torch.cos(rbox[..., 4]), torch.sin(rbox[..., 4])
    w2, h2 = rbox[..., 2] / 2, rbox[..., 3] / 2
    v1 = torch.stack([w2 * c, w2 * s], -1)
    v2 = torch.stack([-h2 * s, h2 * c], -1)
    ctr = rbox[..., :2]
    return torch.stack([ctr + v1 + v2, ctr + v1 - v2, ctr - v1 - v2, ctr - v1 + v2], -2)


def rbox_hull(rbox: torch.Tensor) -> torch.Tensor:
    """The axis-aligned hull (..., 4) xyxy of rotated boxes (..., 5) (JAX :203-208)."""
    pts = xywhr2xyxyxyxy(rbox)
    return torch.cat([pts.amin(-2), pts.amax(-2)], -1)


def regularize_rboxes(rboxes: torch.Tensor) -> torch.Tensor:
    """Rotated boxes (..., 5) [x, y, w, h, angle] with the longer side as w and the angle in [0, pi)
    (JAX `ops/boxes.py:267`): where h >= w the sides swap and the angle turns by pi / 2."""
    x, y, w, h, t = rboxes.unbind(-1)
    long_first = w > h
    w_, h_ = torch.where(long_first, w, h), torch.where(long_first, h, w)
    t_ = torch.remainder(torch.where(long_first, t, t + math.pi / 2), math.pi)
    return torch.stack([x, y, w_, h_, t_], -1)
