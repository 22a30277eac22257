"""v8 / v10 detection losses on the head's raw maps.

Counterpart of `lpc_yolo_tpu/losses/detection.py` (:28-171; reference
loss.py:63-106 BboxLoss, :147-249 v8DetectionLoss, :717-727 v10DetectLoss =
one2many top-10 + one2one top-1). Ground truths arrive padded to a fixed M
(`mask_gt` marks the real rows), so every tensor keeps its padded shape and
the foreground gathers are elementwise multiplies.

The head maps are per-level NCHW `(box_map (B, 4*reg_max, H, W), cls_map
(B, nc, H, W))` pairs; they are flattened in NHWC order (h-major, w-minor,
levels in stride order), the anchor order of the JAX package. All loss math
is f32: the maps are cast where they are used, so a bf16 forward loses no
precision here. The assigner's inputs and outputs are detached.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..ops.anchors import bbox2dist, dfl_expectation, dist2bbox, make_anchors
from ..ops.boxes import bbox_iou
from .tal import task_aligned_assigner


class LossItems(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _df_loss(pred_dist_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss (loss.py:88-106).

    pred_dist_logits: (..., 4, reg_max) raw logits; target: (..., 4) in
    [0, reg_max - 1). Returns (..., 1): the mean over the 4 sides. The right
    bin index is clipped to reg_max - 1.
    """
    reg_max = pred_dist_logits.shape[-1]
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = pred_dist_logits.log_softmax(-1)
    ce = -(logp.gather(-1, tl[..., None]).squeeze(-1) * wl
           + logp.gather(-1, tr.clamp(max=reg_max - 1)[..., None]).squeeze(-1) * wr)
    return ce.mean(-1, keepdim=True)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise (the JAX `optax_sigmoid_bce`)."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def flatten_maps(feats: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """Per-level NCHW (box, cls) pairs -> f32 (B, A, 4*reg_max), (B, A, nc) and the (h, w) per level."""
    B = feats[0][0].shape[0]
    box = torch.cat([bm.permute(0, 2, 3, 1).reshape(B, -1, bm.shape[1]) for bm, _ in feats], 1).float()
    cls = torch.cat([cm.permute(0, 2, 3, 1).reshape(B, -1, cm.shape[1]) for _, cm in feats], 1).float()
    return box, cls, [(cm.shape[2], cm.shape[3]) for _, cm in feats]


def v8_detection_loss(
    feats: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # per-level NCHW (box_map, cls_map)
    gt_labels: torch.Tensor,  # (B, M) integer
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy, pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    strides: Sequence[float],
    nc: int,
    reg_max: int = 16,
    tal_topk: int = 10,
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
    return_assign: bool = False,
):
    """One head-branch detection loss (loss.py:186-249): (total * batch_size, detached LossItems), and
    the assigner's result after them with `return_assign` (the seg loss reads it)."""
    pred_distri, pred_scores, feat_shapes = flatten_maps(feats)
    B, A = pred_scores.shape[:2]
    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=pred_scores.device)

    # decode boxes in feature-grid units
    pred_bboxes = dist2bbox(dfl_expectation(pred_distri, reg_max), anchor_points, xywh=False)  # (B, A, 4)

    assign = task_aligned_assigner(
        pred_scores.detach().sigmoid(),
        (pred_bboxes * stride_tensor).detach(),
        anchor_points * stride_tensor,
        gt_labels,
        gt_bboxes.float(),
        mask_gt,
        topk=tal_topk,
        num_classes=nc,
        alpha=0.5,
        beta=6.0,
    )
    target_scores = assign.target_scores
    fg = assign.fg_mask.float()  # (B, A)
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    # cls: BCE with logits, summed over everything
    loss_cls = sigmoid_bce(pred_scores, target_scores).sum() / target_scores_sum

    # box: CIoU on the foreground anchors
    tb = assign.target_bboxes / stride_tensor
    weight = target_scores.sum(-1) * fg  # (B, A)
    iou = bbox_iou(pred_bboxes, tb, xywh=False, CIoU=True).squeeze(-1)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

    # dfl
    target_ltrb = bbox2dist(anchor_points, tb, reg_max - 1)  # (B, A, 4)
    dfl = _df_loss(pred_distri.reshape(B, A, 4, reg_max), target_ltrb).squeeze(-1)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    box, cls, dfl = loss_box * box_gain, loss_cls * cls_gain, loss_dfl * dfl_gain
    items = LossItems(box.detach(), cls.detach(), dfl.detach())
    if return_assign:
        return (box + cls + dfl) * B, items, assign
    return (box + cls + dfl) * B, items


def v10_detect_loss(
    preds: Dict[str, Sequence[Tuple[torch.Tensor, torch.Tensor]]],
    gt_labels: torch.Tensor,
    gt_bboxes: torch.Tensor,
    mask_gt: torch.Tensor,
    strides: Sequence[float],
    nc: int,
    reg_max: int = 16,
    **gains,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-assignment loss (loss.py:717-727): one2many (top-10) + one2one (top-1).

    Returns (scalar total, (6,) detached items = [box, cls, dfl] of one2many, then of one2one).
    """
    t_om, i_om = v8_detection_loss(preds["one2many"], gt_labels, gt_bboxes, mask_gt, strides, nc, reg_max,
                                   tal_topk=10, **gains)
    t_oo, i_oo = v8_detection_loss(preds["one2one"], gt_labels, gt_bboxes, mask_gt, strides, nc, reg_max,
                                   tal_topk=1, **gains)
    return t_om + t_oo, torch.stack([*i_om, *i_oo])
