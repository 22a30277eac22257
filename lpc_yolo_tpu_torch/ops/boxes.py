"""Box conversions and IoU (counterpart of `lpc_yolo_tpu/ops/boxes.py`
xywh2xyxy :19, bbox_iou :72, scale_boxes :174, clip_boxes :195; reference
ops.py, metrics.py)."""

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


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, CIoU: bool = False,
             eps: float = EPS) -> torch.Tensor:
    """Elementwise IoU (or CIoU) of aligned boxes, broadcasting; last axis = 4.

    Returns the broadcast shape with a trailing singleton axis. In CIoU the
    trade-off weight `alpha` is a constant of the gradient (detached), and the
    xyxy heights carry `+ eps` as in the reference (metrics.py:78).
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
    if not CIoU:
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
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
