"""Task-aligned assignment at padded static shapes (B, M, A).

Counterpart of `lpc_yolo_tpu/losses/tal.py::task_aligned_assigner` (:32-148;
reference tal.py:13-290), both branches: with `rotated` the boxes are (..., 5)
[cx, cy, w, h, angle], an anchor is a candidate when it lies in the rotated
rectangle (its projections on the corner edges ab and ad, `>=` 0 and `<=`
the squared edge lengths, JAX :53-67) and the overlap is probIoU (:81-82). Ground truths arrive padded to a
fixed M with `mask_gt` marking the real rows, and every branch of the
reference is an always-applied select, as in the JAX package.

Ties decide targets: the metric is exactly 0 outside the valid candidates, so
a gt with fewer than `topk` positive anchors picks zeros, and zeros inside
the gt survive. The top-k mask is therefore built by `topk` rounds of
argmax-and-suppress (torch.argmax returns the first maximum, on the CPU and on
CUDA), the order the JAX package uses; torch.topk promises none among ties.
Nothing here is differentiated: the loss detaches what it passes in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import bbox_iou, probiou, xywhr2xyxyxyxy


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy, or (B, A, 5) rotated
    target_scores: torch.Tensor  # (B, A, nc) soft targets
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


@torch.no_grad()
def task_aligned_assigner(
    pd_scores: torch.Tensor,  # (B, A, nc) post-sigmoid
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy (or (B, A, 5) rotated), image units
    anc_points: torch.Tensor,  # (A, 2) image units
    gt_labels: torch.Tensor,  # (B, M) integer
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy (or (B, M, 5) rotated), image units
    mask_gt: torch.Tensor,  # (B, M) bool: valid (non-pad) gt rows
    topk: int = 10,
    num_classes: int = 80,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    rotated: bool = False,
) -> AssignResult:
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    mask_gt_f = mask_gt.to(pd_scores.dtype)

    if rotated:  # anchors inside each rotated gt: projections onto its corner edges ab and ad
        corners = xywhr2xyxyxyxy(gt_bboxes)  # (B, M, 4, 2)
        a_pt, b_pt, d_pt = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
        ab, ad = b_pt - a_pt, d_pt - a_pt  # (B, M, 2)
        ap = anc_points[None, None] - a_pt[..., None, :]  # (B, M, A, 2)
        dot_ab = (ap * ab[..., None, :]).sum(-1)
        dot_ad = (ap * ad[..., None, :]).sum(-1)
        norm_ab = (ab * ab).sum(-1, keepdim=True)
        norm_ad = (ad * ad).sum(-1, keepdim=True)
        mask_in_gts = ((dot_ab >= 0) & (dot_ab <= norm_ab) & (dot_ad >= 0) & (dot_ad <= norm_ad)).to(pd_scores.dtype)
    else:  # candidates whose centre lies inside each gt
        lt = gt_bboxes[..., None, :2]  # (B, M, 1, 2)
        rb = gt_bboxes[..., None, 2:]
        deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], -1)
        mask_in_gts = (deltas.amin(-1) > eps).to(pd_scores.dtype)  # (B, M, A)

    # align metric = score^alpha * IoU^beta on the valid candidates (CIoU, or probIoU when rotated)
    valid = mask_in_gts * mask_gt_f[..., None]
    labels = gt_labels.long().clamp(0, nc - 1)
    bbox_scores = pd_scores.transpose(1, 2).gather(1, labels[:, :, None].expand(B, M, A)) * valid
    if rotated:
        overlaps = probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
    else:
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True).squeeze(-1)
    overlaps = overlaps.clamp(min=0) * valid
    align_metric = bbox_scores ** alpha * overlaps ** beta

    # top-k mask per gt: argmax-and-suppress rounds, lowest index first among ties
    metric = align_metric.clone()
    mask_topk = torch.zeros_like(align_metric)
    for _ in range(topk):
        pick = metric.argmax(-1, keepdim=True)
        mask_topk.scatter_(-1, pick, 1.0)
        metric.scatter_(-1, pick, float("-inf"))
    mask_pos = mask_topk * valid  # (B, M, A)

    # an anchor claimed by several gts goes to the one with the largest CIoU
    fg_counts = mask_pos.sum(-2)  # (B, A)
    max_overlaps_idx = overlaps.argmax(-2)  # (B, A), first gt among ties
    is_max_overlaps = torch.zeros_like(mask_pos).scatter_(1, max_overlaps_idx[:, None], 1.0)
    mask_pos = torch.where((fg_counts > 1)[:, None, :], is_max_overlaps, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0
    target_gt_idx = mask_pos.argmax(-2)  # (B, A)

    target_labels = labels.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, A, gt_bboxes.shape[-1]))
    target_scores = torch.zeros(B, A, num_classes, dtype=pd_scores.dtype, device=pd_scores.device)
    target_scores.scatter_(2, target_labels[..., None], fg_mask[..., None].to(pd_scores.dtype))

    # normalise the soft targets by each gt's best metric
    align_metric = align_metric * mask_pos
    pos_align_metrics = align_metric.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm_align_metric = (align_metric * pos_overlaps / (pos_align_metrics + eps)).amax(-2)  # (B, A)
    target_scores = target_scores * norm_align_metric[..., None]
    return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
