"""The YOLOv8 segmentation loss (counterpart of `lpc_yolo_tpu/losses/segment.py::v8_segmentation_loss`,
:25-88; reference loss.py:250-430 v8SegmentationLoss).

The v8 detection loss with its assignment, plus a mask BCE over a fixed
budget of foreground anchors an image: the `fg_budget` anchors of highest
assigned score (ties in index order, as `jax.lax.top_k` breaks them: a
stable descending sort, not `torch.topk`, whose tie order is unspecified),
each anchor's predicted mask `mc @ proto` against its assigned instance's
mask, cropped to the target box in mask pixels and normalised by the box's
area, then the mean over the true foreground rows times the box gain. All
in f32: a bf16 forward's maps are cast where they are read.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .detection import sigmoid_bce, v8_detection_loss


def v8_segmentation_loss(
    out: Dict,  # {"feats": per-level NCHW (box, cls) pairs, "mc": (B, A, nm), "proto": (B, nm, mh, mw)}
    gt_labels: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    gt_masks: torch.Tensor,  # (B, M, mh, mw) instance masks at the prototypes' resolution (uint8 or float)
    strides,
    nc: int,
    reg_max: int = 16,
    tal_topk: int = 10,
    box_gain: float = 7.5,
    cls_gain: float = 0.5,
    dfl_gain: float = 1.5,
    fg_budget: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total loss, (4,) detached items = box, seg, cls, dfl)."""
    feats, mc, proto = out["feats"], out["mc"], out["proto"]
    total_det, items, assign = v8_detection_loss(feats, gt_labels, gt_bboxes, mask_gt, strides, nc, reg_max, tal_topk,
                                                 box_gain, cls_gain, dfl_gain, return_assign=True)
    B, A, nm = mc.shape
    mh, mw = proto.shape[2], proto.shape[3]
    imgsz_h = feats[0][0].shape[2] * int(strides[0])
    imgsz_w = feats[0][0].shape[3] * int(strides[0])

    score = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    k = min(fg_budget, A)
    topv, topi = score.sort(dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    valid = topv > 0  # true foreground rows only

    sel_mc = mc.float().gather(1, topi[..., None].expand(B, k, nm))  # (B, k, nm)
    sel_gt = assign.target_gt_idx.gather(1, topi)  # (B, k)
    sel_boxes = assign.target_bboxes.gather(1, topi[..., None].expand(B, k, 4))  # (B, k, 4) px
    gt_m = gt_masks[torch.arange(B, device=mc.device)[:, None], sel_gt].float()  # (B, k, mh, mw)
    pm = torch.einsum("bkn,bnhw->bkhw", sel_mc, proto.float())

    # crop to the target box in mask pixels, BCE normalised by the box area (loss.py:340-366)
    sx, sy = mw / imgsz_w, mh / imgsz_h
    bx = sel_boxes * torch.tensor([sx, sy, sx, sy], dtype=sel_boxes.dtype, device=sel_boxes.device)
    x1, y1, x2, y2 = bx[..., None, None].unbind(2)  # each (B, k, 1, 1)
    c = torch.arange(mw, device=mc.device, dtype=torch.float32).view(1, 1, 1, mw)
    r = torch.arange(mh, device=mc.device, dtype=torch.float32).view(1, 1, mh, 1)
    crop = ((c >= x1) & (c < x2) & (r >= y1) & (r < y2)).float()
    bce = sigmoid_bce(pm, gt_m) * crop
    area = ((x2 - x1) * (y2 - y1)).clamp(min=1.0)[..., 0, 0]  # (B, k)
    per_anchor = bce.sum((2, 3)) / area
    fg_count = valid.float().sum().clamp(min=1.0)
    loss_seg = (per_anchor * valid).sum() / fg_count * box_gain
    total = total_det + loss_seg * B
    return total, torch.stack([items.box, loss_seg.detach(), items.cls, items.dfl])
