"""RT-DETR's training loss: Hungarian matching, the contrastive-denoising group and the DETR loss.

Counterpart of `lpc_yolo_tpu/losses/detr.py` (reference models/utils/ops.py:12-252 HungarianMatcher and
get_cdn_group, models/utils/loss.py:12-345 DETRLoss and RTDETRDetectionLoss).

* Matching. The cost of a query for a ground truth is 2 * focal + 5 * L1 + 2 * (1 - GIoU) on normalised cxcywh
  boxes; a non-finite cost becomes 1e6, and the cost carries no gradient. The costs of every layer that a step
  matches (the decoder's layers and the encoder head) are computed on the device at once, copied to the host in
  one transfer with the ground-truth counts, solved there per layer and image by scipy's linear_sum_assignment
  over the first n_valid ground-truth slots, and the (L, B, M) query indices (-1 for padding) come back in one
  transfer. The JAX package makes one host round trip per layer (`pure_callback`); the answer is the same.
* Denoising. G = max(1, NUM_DN // M) groups of M positives and M negatives: each ground truth's label is
  flipped to a random class with probability CLS_NOISE / 2, and its box corners move by up to half its
  size (positives, inside the box) or by one to one and a half times that (negatives, pushed outside it). The
  padded slots keep zero embeddings and a zero box logit (a 0.5 box) and stay in the tensor: dropping them would
  change every attention row. The four draws (flip, label, sign, part) come from a `torch.Generator`, seeded from
  the train step's count as the JAX step seeds its key from it, so a resumed run draws what an uninterrupted one
  would; they can also be given as tensors.
* The losses. Each matched layer has a varifocal class term (IoU-aware targets at the matched queries, built by
  scatter-add; the IoU is a constant of the gradient) plus L1 and GIoU on the matched pairs, all divided by the
  number of ground truths; the denoising group's positive slot m matches ground truth m, its loss divided by that
  number times G. Every loss function takes an optional precomputed match.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou, xywh2xyxy
from .detection import sigmoid_bce

COST_GAIN = (2.0, 5.0, 2.0)  # class, bbox, giou (JAX :63)
LOSS_GAIN = (1.0, 5.0, 2.0)  # class, bbox, giou (JAX :162-164, :210-212)
NUM_DN, CLS_NOISE, BOX_NOISE = 100, 0.5, 1.0  # denoising queries asked for, label and box noise (JAX :110-112)
DN_SEED = 42  # the JAX step's dn key is fold_in(PRNGKey(42), step)


def normalized_cxcywh(bboxes_px: torch.Tensor, imgsz: Sequence[int]) -> torch.Tensor:
    """(..., 4) xyxy pixel boxes on an (h, w) input -> normalised cxcywh (JAX :263-268)."""
    h, w = imgsz
    xyxy = bboxes_px / torch.tensor([w, h, w, h], dtype=bboxes_px.dtype, device=bboxes_px.device)
    return torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)


def _focal_class_cost(scores: torch.Tensor, gt_cls: torch.Tensor, alpha: float = 0.25,
                      gamma: float = 2.0) -> torch.Tensor:
    """(..., B, nq, nc) sigmoid scores x (B, M) labels -> (..., B, nq, M) focal cost (JAX :29-37)."""
    pos = alpha * ((1 - scores) ** gamma) * (-torch.log(scores + 1e-8))
    neg = (1 - alpha) * (scores ** gamma) * (-torch.log(1 - scores + 1e-8))
    cost = pos - neg
    idx = gt_cls.long().clamp(0, scores.shape[-1] - 1)[:, None, :]
    return cost.gather(-1, idx.expand(*cost.shape[:-1], idx.shape[-1]))


@torch.no_grad()
def match_cost(pred_boxes: torch.Tensor, pred_logits: torch.Tensor, gt_boxes: torch.Tensor,
               gt_cls: torch.Tensor) -> torch.Tensor:
    """The matching cost (..., B, nq, M) of predictions (..., B, nq, 4) normalised cxcywh and (..., B, nq, nc)
    logits against ground truths (B, M, 4) and (B, M); non-finite costs are 1e6 (JAX :65-72)."""
    c_cls = _focal_class_cost(pred_logits.sigmoid(), gt_cls)
    c_l1 = (pred_boxes[..., :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    giou = bbox_iou(xywh2xyxy(pred_boxes)[..., :, None, :], xywh2xyxy(gt_boxes)[:, None, :, :], xywh=False,
                    GIoU=True).squeeze(-1)
    cost = COST_GAIN[0] * c_cls + COST_GAIN[1] * c_l1 + COST_GAIN[2] * (1.0 - giou)
    return torch.where(torch.isfinite(cost), cost, 1e6)


def _lsa_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """(N, nq, M) costs and (N,) ground-truth counts -> (N, M) int32 matched query per ground-truth slot, -1 for
    padding (JAX :40-53)."""
    from scipy.optimize import linear_sum_assignment

    N, _, M = cost.shape
    out = np.full((N, M), -1, np.int32)
    for n in range(N):
        k = int(n_valid[n])
        if k == 0:
            continue
        r, c = linear_sum_assignment(cost[n, :, :k])
        out[n, c] = r.astype(np.int32)
    return out


def solve_matches(cost: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    """(..., B, nq, M) costs and the (B, M) ground-truth mask -> (..., B, M) int64 matched query indices, -1 for
    padding: the costs and the counts go to the host in one copy, scipy solves every (layer, image), and the
    indices come back in one copy."""
    *lead, nq, M = cost.shape
    n_valid = mask_gt.sum(-1).to(cost.dtype).expand(*lead)
    host = torch.cat([cost.reshape(-1), n_valid.reshape(-1)]).cpu().numpy()
    out = _lsa_host(host[:cost.numel()].reshape(-1, nq, M), host[cost.numel():])
    return torch.from_numpy(out).to(cost.device).long().view(*lead, M)


def hungarian_match(pred_boxes: torch.Tensor, pred_logits: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_cls: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
    """(B, M) matched query per ground truth (-1 for padding) of (B, nq, ...) predictions (JAX :56-83), or
    (L, B, M) of L layers' (L, B, nq, ...) predictions at once, through one `solve_matches`."""
    return solve_matches(match_cost(pred_boxes, pred_logits, gt_boxes, gt_cls), mask_gt)


def get_cdn_attn_mask(M: int, G: int, nq: int, device=None) -> torch.Tensor:
    """The denoising attention mask (2GM + nq, 2GM + nq), True = blocked (JAX :86-99): the matching queries see
    no denoising query, and no group sees another, in the reference's 2M-wide group stripes."""
    num_dn = 2 * G * M
    mask = torch.zeros(num_dn + nq, num_dn + nq, dtype=torch.bool, device=device)
    mask[num_dn:, :num_dn] = True
    for i in range(G):
        lo, hi = 2 * M * i, 2 * M * (i + 1)
        mask[lo:hi, hi:num_dn] = True
        mask[lo:hi, :lo] = True
    return mask


def dn_generator(step: int, device) -> torch.Generator:
    """The generator of a train step's denoising draws, seeded from the step's count."""
    return torch.Generator(device=device).manual_seed(DN_SEED * 2 ** 32 + int(step))


def dn_draws(B: int, G: int, M: int, nc: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The four draws of a denoising group (JAX :123-136), on the generator's device: 'flip' (B, 2G, M) uniform in
    [0, 1) (a label flips under CLS_NOISE / 2), 'label' (B, 2G, M) the random class, 'sign' (B, 2G, M, 4) of +-1
    and 'part' (B, 2G, M, 4) uniform in [0, 1), all f32 draws whatever the model's dtype."""
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return {"flip": torch.rand(B, 2 * G, M, **kw), "label": torch.randint(0, nc, (B, 2 * G, M), **kw),
            "sign": torch.randint(0, 2, (B, 2 * G, M, 4), **kw).float() * 2.0 - 1.0,
            "part": torch.rand(B, 2 * G, M, 4, **kw)}


def get_cdn_group(gt_cls: torch.Tensor, gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, nc: int,
                  class_embed: torch.Tensor, num_queries: int, generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
    """The contrastive-denoising queries of a batch of ground truths (B, M) labels, (B, M, 4) normalised cxcywh
    boxes and (B, M) mask (JAX :102-152, at its default num_dn, noise ratio and scale), from `draws` (`dn_draws`'s
    keys) or from `generator`.

    Returns (dn_embed (B, 2GM, hd) rows of `class_embed` (nc, hd), zero at padded slots; dn_bbox_logit (B, 2GM, 4)
    the noised boxes' logits, zero at padded slots; the attention mask (2GM + nq, 2GM + nq), True = blocked; G).
    """
    B, M = gt_cls.shape
    G = max(1, NUM_DN // max(M, 1))
    if draws is None:
        draws = dn_draws(B, G, M, nc, generator)
    cls = gt_cls.long()[:, None, :].expand(B, 2 * G, M)
    box = gt_bboxes[:, None].expand(B, 2 * G, M, 4)
    valid = mask_gt[:, None, :, None].to(gt_bboxes.dtype)  # (B, 1, M, 1)
    cls = torch.where(draws["flip"] < CLS_NOISE * 0.5, draws["label"].long(), cls)
    xyxy = xywh2xyxy(box)
    diff = (box[..., 2:] * 0.5).repeat(1, 1, 1, 2) * BOX_NOISE
    neg = (torch.arange(2 * G, device=box.device) >= G)[None, :, None, None]  # the negative groups
    part = draws["part"].to(box.dtype) + neg.to(box.dtype)  # negatives pushed outside the box
    xyxy = (xyxy + part * draws["sign"].to(box.dtype) * diff).clamp(0.0, 1.0)
    box = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)
    box = box.clamp(1e-6, 1 - 1e-6)
    dn_bbox = torch.log(box / (1.0 - box)) * valid  # inverse sigmoid; padded slots 0
    emb = class_embed[cls.clamp(0, nc - 1)] * valid.to(class_embed.dtype)  # padded slots: zeros
    attn_mask = get_cdn_attn_mask(M, G, num_queries, device=gt_cls.device)
    return emb.reshape(B, 2 * G * M, -1), dn_bbox.reshape(B, 2 * G * M, 4), attn_mask, G


def _box_terms(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed L1 and 1 - GIoU of aligned cxcywh boxes, over the valid pairs."""
    l1 = (pred - gt).abs().sum(-1) * valid
    giou = bbox_iou(xywh2xyxy(pred), xywh2xyxy(gt), xywh=False, GIoU=True).squeeze(-1)
    return l1.sum(), ((1.0 - giou) * valid).sum()


def _vfl(logits: torch.Tensor, gt_score: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """The summed varifocal loss of logits against IoU-aware targets (JAX :188-190, :236-238)."""
    p = logits.sigmoid()
    weight = 0.75 * p ** 2.0 * (1.0 - one_hot) + gt_score * one_hot
    return (sigmoid_bce(logits, gt_score) * weight).sum()


def detr_loss_fixed_match(dn_bboxes: torch.Tensor, dn_scores: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_cls: torch.Tensor, mask_gt: torch.Tensor, num_group: int) -> torch.Tensor:
    """The denoising loss (JAX :155-200) of (L, B, 2GM, 4) boxes and (L, B, 2GM, nc) logits: in each group g < G
    the positive slot m matches ground truth m; the negatives and the padded slots are background."""
    L, B, _, nc = dn_scores.shape
    G, M = num_group, gt_boxes.shape[1]
    dt = dn_scores.dtype
    valid = mask_gt[:, None, :].to(dt)  # (B, 1, M)
    num_gts = (valid.sum() * G).clamp(min=1.0)
    onehot = F.one_hot(gt_cls.long().clamp(0, nc - 1), nc).to(dt)[:, None] * valid[..., None]  # (B, 1, M, nc)
    background = torch.zeros(B, G, M, nc, dtype=dt, device=dn_scores.device)
    one_hot_map = torch.cat([onehot.expand(B, G, M, nc), background], 1)
    total = 0.0
    for pb, ps in zip(dn_bboxes, dn_scores):
        pos = pb.reshape(B, 2 * G, M, 4)[:, :G]
        ps = ps.reshape(B, 2 * G, M, nc)
        gt_b = gt_boxes[:, None].expand_as(pos)
        iou = bbox_iou(xywh2xyxy(pos), xywh2xyxy(gt_b), xywh=False).squeeze(-1)  # (B, G, M)
        gt_score = torch.cat([onehot * (iou.detach() * valid)[..., None], background], 1)
        loss_cls = _vfl(ps, gt_score, one_hot_map) / num_gts
        l1, giou = _box_terms(pos, gt_b, valid)
        total = total + LOSS_GAIN[0] * loss_cls + LOSS_GAIN[1] * (l1 / num_gts) + LOSS_GAIN[2] * (giou / num_gts)
    return total


def detr_loss(dec_bboxes: torch.Tensor, dec_scores: torch.Tensor, gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
              mask_gt: torch.Tensor, match: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DETR loss summed over L layers (JAX :203-254) of (L, B, nq, 4) boxes and (L, B, nq, nc) logits, with
    each layer's (L, B, M) `match` (computed here, all layers in one `hungarian_match`, when not given).

    Returns (total, the last layer's [cls, l1, giou], detached)."""
    L, B, nq, nc = dec_scores.shape
    if match is None:
        match = hungarian_match(dec_bboxes, dec_scores, gt_boxes, gt_cls, mask_gt)
    dt = dec_scores.dtype
    num_gts = mask_gt.to(dt).sum().clamp(min=1.0)
    onehot_cls = F.one_hot(gt_cls.long().clamp(0, nc - 1), nc).to(dt)  # (B, M, nc)
    total, items = 0.0, None
    for pb, ps, m in zip(dec_bboxes, dec_scores, match):
        valid = ((m >= 0) & mask_gt.bool()).to(dt)  # (B, M)
        safe = m.clamp(0, nq - 1)
        mp = pb.gather(1, safe[..., None].expand(-1, -1, 4))  # (B, M, 4)
        iou = bbox_iou(xywh2xyxy(mp), xywh2xyxy(gt_boxes), xywh=False).squeeze(-1)
        onehot = onehot_cls * valid[..., None]
        at = safe[..., None].expand(-1, -1, nc)
        zeros = torch.zeros(B, nq, nc, dtype=dt, device=ps.device)
        one_hot_map = zeros.scatter_add(1, at, onehot)
        gt_score_map = zeros.scatter_add(1, at, onehot * (iou.detach() * valid)[..., None])
        loss_cls = _vfl(ps, gt_score_map, one_hot_map) / num_gts
        l1, giou = _box_terms(mp, gt_boxes, valid)
        loss_bbox, loss_giou = l1 / num_gts, giou / num_gts
        total = total + LOSS_GAIN[0] * loss_cls + LOSS_GAIN[1] * loss_bbox + LOSS_GAIN[2] * loss_giou
        items = torch.stack([loss_cls, loss_bbox, loss_giou])
    return total, items.detach()


def rtdetr_loss(out: Dict, gt_labels: torch.Tensor, gt_bboxes_px: torch.Tensor, mask_gt: torch.Tensor,
                imgsz: Sequence[int], matches: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss of the decoder's train output (JAX :257-280): pixel xyxy ground truths on an (h, w) input ->
    normalised cxcywh; the first `dn_split` queries of every layer are the denoising group's; the decoder's
    layers' and the encoder head's DETR losses plus the denoising loss. `matches` (ndl + 1, B, M): the decoder
    layers' and then the encoder head's, all matched here through one `hungarian_match` when not given.

    Returns (total, the last decoder layer's [cls, l1, giou], detached)."""
    dec_b, dec_s = out["dec_bboxes"], out["dec_scores"]
    enc_b, enc_s = out["enc_bboxes"][None], out["enc_scores"][None]
    gt = normalized_cxcywh(gt_bboxes_px.to(dec_b.dtype), imgsz)
    num_dn = int(out.get("dn_split", 0))
    dn_total = 0.0
    if num_dn:
        dn_total = detr_loss_fixed_match(dec_b[:, :, :num_dn], dec_s[:, :, :num_dn], gt, gt_labels, mask_gt,
                                         int(out["dn_group"]))
        dec_b, dec_s = dec_b[:, :, num_dn:], dec_s[:, :, num_dn:]
    L = dec_b.shape[0]
    if matches is None:
        cost = torch.cat([match_cost(dec_b, dec_s, gt, gt_labels), match_cost(enc_b, enc_s, gt, gt_labels)])
        matches = solve_matches(cost, mask_gt)
    total, items = detr_loss(dec_b, dec_s, gt, gt_labels, mask_gt, match=matches[:L])
    enc_total, _ = detr_loss(enc_b, enc_s, gt, gt_labels, mask_gt, match=matches[L:])
    return total + enc_total + dn_total, items
