"""The YOLOv8 pose loss (counterpart of `lpc_yolo_tpu/losses/pose.py::v8_pose_loss`, :27-106;
reference loss.py:433-588 v8PoseLoss, :130-145 KeypointLoss).

The v8 detection loss with its assignment, plus over a fixed budget of
foreground anchors an image (the `fg_budget` anchors of highest assigned
score, ties in index order as `jax.lax.top_k` breaks them: a stable
descending sort, as in `losses/segment.py`) an OKS-style location loss of
each anchor's decoded keypoints against its assigned instance's, and with
ndim 3 a visibility BCE (`kobj`). Gains: pose 12, kobj 1. All in f32: a
bf16 forward's maps are cast where they are read.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.anchors import make_anchors
from .detection import sigmoid_bce, v8_detection_loss

# COCO's 17-keypoint OKS sigmas (the public COCO eval constants; reference loss.py:455)
OKS_SIGMA = np.array(
    [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
) / 10.0


def v8_pose_loss(
    out: Dict,  # {"feats": per-level NCHW (box, cls) pairs, "kpt_raw": (B, A, nk)}
    gt_labels: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    gt_kpts: torch.Tensor,  # (B, M, K, ndim) pixels (+ visibility)
    strides,
    nc: int,
    kpt_shape: Tuple[int, int] = (17, 3),
    reg_max: int = 16,
    pose_gain: float = 12.0,
    kobj_gain: float = 1.0,
    fg_budget: int = 64,
    tal_topk: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total loss, (5,) detached items = box, pose, kobj, cls, dfl)."""
    feats, kpt_raw = out["feats"], out["kpt_raw"]
    total_det, items, assign = v8_detection_loss(feats, gt_labels, gt_bboxes, mask_gt, strides, nc, reg_max, tal_topk,
                                                 return_assign=True)
    B, A, nk = kpt_raw.shape
    nkpt, ndim = kpt_shape
    feat_shapes = [(cm.shape[2], cm.shape[3]) for _, cm in feats]
    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=kpt_raw.device)

    # the predicted keypoints decoded to pixels (head.py kpts_decode)
    y = kpt_raw.float().reshape(B, A, nkpt, ndim)
    pxy = (y[..., :2] * 2.0 + (anchor_points[None, :, None] - 0.5)) * stride_tensor[None, :, None]

    score = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    k = min(fg_budget, A)
    topv, topi = score.sort(dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    valid = (topv > 0).float()  # true foreground rows only
    sel_gt = assign.target_gt_idx.gather(1, topi)  # (B, k)
    sel_pxy = pxy.gather(1, topi[..., None, None].expand(B, k, nkpt, 2))  # (B, k, K, 2)
    sel_boxes = assign.target_bboxes.gather(1, topi[..., None].expand(B, k, 4))  # (B, k, 4)
    gtk = gt_kpts.float().gather(1, sel_gt[..., None, None].expand(B, k, nkpt, ndim))  # (B, k, K, ndim)
    kpt_mask = (gtk[..., 2] != 0).float() if ndim == 3 else torch.ones_like(gtk[..., 0])

    area = ((sel_boxes[..., 2] - sel_boxes[..., 0]) * (sel_boxes[..., 3] - sel_boxes[..., 1])).clamp(min=1.0)[..., None]
    sigmas = torch.as_tensor(OKS_SIGMA[:nkpt], dtype=torch.float32, device=kpt_raw.device)
    d2 = ((sel_pxy - gtk[..., :2]) ** 2).sum(-1)  # (B, k, K)
    e = d2 / ((2 * sigmas) ** 2 * (area + 1e-9) * 2)
    kpt_loss_factor = nkpt / (kpt_mask.sum(-1, keepdim=True) + 1e-9)
    loc = (kpt_loss_factor * (1 - torch.exp(-e)) * kpt_mask).sum(-1)  # (B, k)
    # KeypointLoss is a plain mean over (n_fg, K): no score weighting (loss.py:130-145, :578)
    fg_count = valid.sum().clamp(min=1.0)
    loss_pose = (loc * valid).sum() / (fg_count * nkpt)
    if ndim == 3:
        pv = y[..., 2].gather(1, topi[..., None].expand(B, k, nkpt))  # (B, k, K)
        loss_kobj = (sigmoid_bce(pv, kpt_mask).mean(-1) * valid).sum() / fg_count
    else:
        loss_kobj = loss_pose.new_zeros(())

    total = total_det + (pose_gain * loss_pose + kobj_gain * loss_kobj) * B
    items_out = torch.stack([items.box, (pose_gain * loss_pose).detach(), (kobj_gain * loss_kobj).detach(),
                             items.cls, items.dfl])
    return total, items_out
