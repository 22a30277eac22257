"""The YOLOv8 oriented-box loss (counterpart of `lpc_yolo_tpu/losses/obb.py::v8_obb_loss`; reference
loss.py:599-715 v8OBBLoss).

The v8 detection loss on rotated boxes: the head's DFL distances decoded about
each anchor by `dist2rbox` with its predicted angle, the rotated task-aligned
assigner (probIoU metric, point-in-rotated-rect candidates) in image units on
[pred_xywh * stride, angle], the probIoU box loss in grid units, and the DFL
on the axis-aligned (cx, cy, w, h) of the target's rotated box (the
reference's choice). Items [box * 7.5, cls * 0.5, dfl * 1.5], total their sum
times the batch size. All in f32: a bf16 forward's maps are cast where read.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..nn.heads import dist2rbox
from ..ops.anchors import bbox2dist, dfl_expectation, make_anchors
from ..ops.boxes import probiou, xywh2xyxy
from .detection import _df_loss, flatten_maps, sigmoid_bce
from .tal import task_aligned_assigner


def v8_obb_loss(
    out: Dict,  # {"feats": per-level NCHW (box, cls) pairs, "angle": (B, A, 1) radians}
    gt_labels: torch.Tensor,  # (B, M)
    gt_rboxes: torch.Tensor,  # (B, M, 5) [cx, cy, w, h, angle] pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    strides,
    nc: int,
    reg_max: int = 16,
    tal_topk: int = 10,
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total loss, (3,) detached items = box, cls, dfl)."""
    pred_distri, pred_scores, feat_shapes = flatten_maps(out["feats"])
    angle = out["angle"].float()
    B, A = pred_scores.shape[:2]
    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=pred_scores.device)
    pred_xywh = dist2rbox(dfl_expectation(pred_distri, reg_max), angle, anchor_points)  # (B, A, 4) grid units
    pred_rboxes = torch.cat([pred_xywh, angle], -1)

    assign = task_aligned_assigner(
        pred_scores.detach().sigmoid(),
        torch.cat([pred_xywh * stride_tensor, angle], -1).detach(),
        anchor_points * stride_tensor,
        gt_labels,
        gt_rboxes.float(),
        mask_gt,
        topk=tal_topk,
        num_classes=nc,
        alpha=0.5,
        beta=6.0,
        rotated=True,
    )
    target_scores = assign.target_scores
    fg = assign.fg_mask.float()
    tss = target_scores.sum().clamp(min=1.0)
    loss_cls = sigmoid_bce(pred_scores, target_scores).sum() / tss

    # probIoU box loss in grid units (RotatedBboxLoss, loss.py:644-660)
    tb = torch.cat([assign.target_bboxes[..., :4] / stride_tensor, assign.target_bboxes[..., 4:]], -1)
    weight = target_scores.sum(-1) * fg
    loss_box = ((1.0 - probiou(pred_rboxes, tb)) * weight).sum() / tss

    # DFL on the axis-aligned xywh of the target's rotated box (loss.py:120-126)
    target_ltrb = bbox2dist(anchor_points, xywh2xyxy(tb[..., :4]), reg_max - 1)
    dfl = _df_loss(pred_distri.reshape(B, A, 4, reg_max), target_ltrb).squeeze(-1)
    loss_dfl = (dfl * weight).sum() / tss

    items = torch.stack([loss_box * box_gain, loss_cls * cls_gain, loss_dfl * dfl_gain])
    return items.sum() * B, items.detach()
