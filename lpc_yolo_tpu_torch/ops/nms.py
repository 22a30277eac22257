"""Static-shape batched class-offset NMS (counterpart of `lpc_yolo_tpu/ops/postprocess.py:89-185`).

`non_max_suppression` keeps the JAX function's signature and output: the
candidates are cut to a pool of the `pre_topk` best scores (`top_k`, in
`lax.top_k`'s order, over (B, A), or over the anchor-major (B, A*nc) for
`multi_label`), offset by
label * max_wh unless `agnostic`, and then `max_det` greedy steps each take
the best live candidate and suppress every pool box whose IoU with it is
above `iou_thres`. The result is always (B, max_det, 6) = [x1, y1, x2, y2,
score, label], invalid rows all 0 with label -1.

The greedy loop (the JAX `nms_one` scan, :144-163) is `nms_greedy`: on a
CUDA tensor one launch of the hand-written kernel `csrc/nms.cu` (one block
per image, the pool in shared memory), on a CPU tensor `nms_plain`. NMS is
not a Pallas kernel in the JAX package (XLA compiles the scan); on the card a
plain loop would cost ~25 launches a step, 300 steps a batch.

The IoU is computed in the JAX order, `inter / (area1 + area2 - inter +
1e-7)` on the offset boxes, each operation rounded on its own, so the kernel
and `nms_plain` keep the same indices bit for bit on the same pool.

`nms_rotated` is the JAX rotated fast-NMS (:187-280) for oriented boxes:
one pass over the (k, k) probIoU of the score-sorted pool, in plain batched
PyTorch as the JAX package writes it in XLA ops (it is no Pallas kernel there
and no hand-written kernel here).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .boxes import probiou, xywh2xyxy

SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on an H100
POOL_BYTES = 24  # shared memory per pool entry in csrc/nms.cu: offset box, area, live score
MAX_POOL = (SMEM_LIMIT - 512) // POOL_BYTES


def _check(boxes, scores, labels, anchors, max_det: int) -> Tuple[int, int]:
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"expected (B, k, 4) xyxy boxes, got {tuple(boxes.shape)}")
    B, k = boxes.shape[:2]
    for name, t in (("scores", scores), ("labels", labels), ("anchors", anchors)):
        if tuple(t.shape) != (B, k):
            raise ValueError(f"{name} must be (B, k) = {(B, k)}, got {tuple(t.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"boxes and scores must be float32, got {boxes.dtype} and {scores.dtype}")
    if max_det < 1:
        raise ValueError(f"max_det must be positive, got {max_det}")
    return B, k


def _pool_iou(off: torch.Tensor, area: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """IoU of the box at index j[b] against every pool box of image b, in the JAX order: (B, k)."""
    B = off.shape[0]
    bj = off.gather(1, j.view(B, 1, 1).expand(B, 1, 4))  # (B, 1, 4)
    lt = torch.maximum(bj[..., :2], off[..., :2])
    rb = torch.minimum(bj[..., 2:], off[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area.gather(1, j.view(B, 1)) + area - inter + 1e-7)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, anchors: torch.Tensor,
              conf_thres: float, iou_thres: float, max_det: int, agnostic: bool = False,
              max_wh: float = 7680.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the JAX scan over all `max_det` steps, every image at once.

    boxes (B, k, 4) xyxy f32, scores (B, k) f32, labels and anchors (B, k) integer. Returns
    (B, max_det, 6) rows [box, score, label] (invalid: 0, 0, 0, 0, 0, -1) and (B, max_det) int32
    anchors (invalid: 0). No host synchronisation, so a CUDA graph can capture it.
    """
    B, k = _check(boxes, scores, labels, anchors, max_det)
    offset = labels.float()[..., None] * (0.0 if agnostic else max_wh)
    off = boxes + offset
    area = (off[..., 2] - off[..., 0]) * (off[..., 3] - off[..., 1])
    live = torch.where(scores > conf_thres, scores, torch.full_like(scores, -1.0))
    pos = torch.arange(k, device=boxes.device)
    keep = torch.empty(B, max_det, dtype=torch.long, device=boxes.device)
    ok = torch.empty(B, max_det, dtype=torch.bool, device=boxes.device)
    for t in range(max_det):
        best, j = live.max(1)  # the first index of the largest, as jnp.argmax
        ok_t = best > 0.0
        suppress = (ok_t[:, None] & (_pool_iou(off, area, j) > iou_thres)) | (pos[None] == j[:, None])
        live = live.masked_fill(suppress, -1.0)
        keep[:, t] = j
        ok[:, t] = ok_t
    out = torch.cat([torch.where(ok[..., None], boxes.gather(1, keep[..., None].expand(B, max_det, 4)), 0.0),
                     torch.where(ok, scores.gather(1, keep), 0.0)[..., None],
                     torch.where(ok, labels.gather(1, keep).float(), -1.0)[..., None]], -1)
    return out, torch.where(ok, anchors.gather(1, keep), 0).int()


def nms_greedy(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor, anchors: torch.Tensor,
               conf_thres: float, iou_thres: float, max_det: int, agnostic: bool = False,
               max_wh: float = 7680.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy loop over a candidate pool through the hand-written kernel (`csrc/nms.cu`), as
    `nms_plain`. CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    B, k = _check(boxes, scores, labels, anchors, max_det)
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, labels, anchors, conf_thres, iou_thres, max_det, agnostic, max_wh)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_greedy runs on CUDA tensors, got {boxes.device}")
    if k > MAX_POOL:
        raise ValueError(f"nms_greedy holds at most {MAX_POOL} candidates an image in shared memory, got {k}")
    out = torch.empty(B, max_det, 6, dtype=torch.float32, device=boxes.device)
    out_anchor = torch.empty(B, max_det, dtype=torch.int32, device=boxes.device)
    if B == 0:
        return out, out_anchor
    boxes, scores = boxes.contiguous(), scores.contiguous()
    labels, anchors = labels.to(torch.int32).contiguous(), anchors.to(torch.int32).contiguous()
    fn = _build.load("nms").nms_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = fn(boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(), anchors.data_ptr(), out.data_ptr(),
            out_anchor.data_ptr(), B, k, max_det, conf_thres, iou_thres, max_wh, int(agnostic), stream)
    _build.check(rc, "nms")
    nms_greedy.launches += 1
    return out, out_anchor


nms_greedy.launches = 0


def top_candidates(scores_all: torch.Tensor, pre_topk: int, multi_label: bool):
    """(B, A, nc) post-sigmoid scores -> the (B, k) scores, labels and anchors of the candidates: with
    `multi_label` the top `pre_topk` of the anchor-major (B, A * nc) scores, one per (anchor, class);
    otherwise each anchor's best class, then the top `pre_topk` anchors (JAX :123-136, :224-237).

    `top_k` stands for `lax.top_k`: among equal scores the lower index comes first, as `lax.top_k` orders them
    (`torch.topk` promises no order), so the greedy loop meets tied candidates in the JAX order. A World graph
    given zero text scores every class of a level alike."""
    B, A, nc = scores_all.shape
    if multi_label:
        scores, flat_idx = top_k(scores_all.reshape(B, A * nc), pre_topk)
        return scores, flat_idx % nc, flat_idx // nc
    scores_best, labels_best = scores_all.max(-1)
    scores, anchor = top_k(scores_best, pre_topk)
    return scores, labels_best.gather(1, anchor), anchor


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The min(k, n) largest of each row of x (B, n) and their indices, in `lax.top_k`'s order: a stable
    descending sort of the row (`tools/time_nms_pool.py` times it beside `torch.topk` on the card)."""
    values, idx = x.sort(dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def candidate_pool(preds: torch.Tensor, pre_topk: int = 4096, multi_label: bool = False):
    """(B, A, 4 + nc) xywh + scores -> the pool: (B, k, 4) xyxy boxes, (B, k) scores, labels, anchors
    (`top_candidates`; gathers for `take_along_axis`)."""
    scores, labels, anchor = top_candidates(preds[..., 4:], pre_topk, multi_label)
    boxes = xywh2xyxy(preds[..., :4]).gather(1, anchor[..., None].expand(*anchor.shape, 4))
    return boxes, scores, labels, anchor


def non_max_suppression(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, pre_topk: int = 4096, agnostic: bool = False,
                        multi_label: bool = False, max_wh: float = 7680.0, return_anchor_idx: bool = False):
    """preds (B, A, 4 + nc) f32 = xywh boxes + per-class scores (post-sigmoid) -> (B, max_det, 6)
    [x1, y1, x2, y2, score, label], invalid rows all 0 with label -1; with `return_anchor_idx`
    also the (B, max_det) int32 anchor of each row (0 where invalid)."""
    pool = candidate_pool(preds.float(), pre_topk, multi_label)
    out, out_anchor = nms_greedy(*pool, conf_thres, iou_thres, max_det, agnostic, max_wh)
    return (out, out_anchor) if return_anchor_idx else out


PROBIOU_CHUNK = 1 << 23  # pairwise probIoU elements computed at once (images of one batch at a time)


def nms_rotated(rboxes: torch.Tensor, scores_all: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                max_det: int = 300, pre_topk: int = 1024, agnostic: bool = False, multi_label: bool = False,
                max_wh: float = 7680.0) -> torch.Tensor:
    """Static-shape rotated fast-NMS by pairwise probIoU (JAX `ops/postprocess.py::nms_rotated`, :187-280;
    reference ops.py:143-161 and the rotated branch of non_max_suppression).

    rboxes (B, A, 5) [cx, cy, w, h, angle], scores_all (B, A, nc) post-sigmoid; the candidates are
    `top_candidates`'. Unless `agnostic`, label * max_wh is added to both centre coordinates. A candidate
    above `conf_thres` survives when no higher-ranked valid candidate overlaps it by probIoU >= `iou_thres`
    (the column max of the upper triangle; one pass, no suppression chain). Returns (B, max_det, 7)
    [cx, cy, w, h, angle, score, label], rows ranked by score, invalid rows 0 with label -1.

    Both rankings are `top_k`'s, in `lax.top_k`'s order, so candidates of equal score keep the JAX order in the
    triangle and in the output. The (k, k) probIoU is computed `PROBIOU_CHUNK` elements at a time over the
    images, which changes no value.
    """
    rboxes, scores_all = rboxes.float(), scores_all.float()
    scores, labels, anchor = top_candidates(scores_all, pre_topk, multi_label)
    B, k = scores.shape
    cand = rboxes.gather(1, anchor[..., None].expand(B, k, 5))
    valid = scores > conf_thres
    offset = labels.float()[..., None] * (0.0 if agnostic else max_wh)
    off = torch.cat([cand[..., :2] + offset, cand[..., 2:]], -1)
    upper = torch.ones(k, k, dtype=torch.bool, device=rboxes.device).triu(1)
    keep = torch.empty_like(valid)
    step = max(1, PROBIOU_CHUNK // (k * k))
    for b0 in range(0, B, step):
        rb, vl = off[b0:b0 + step], valid[b0:b0 + step]
        iou = probiou(rb[:, :, None], rb[:, None])  # (b, k, k)
        tri = torch.where(upper & vl[:, :, None] & vl[:, None], iou, 0.0)
        keep[b0:b0 + step] = (tri.amax(1) < iou_thres) & vl
    sel = torch.where(keep, scores, -1.0)
    kd = min(max_det, k)
    out_scores, kidx = top_k(sel, kd)
    ok = out_scores > 0
    rows = cand.gather(1, kidx[..., None].expand(B, kd, 5))
    det = torch.cat([torch.where(ok[..., None], rows, 0.0), torch.where(ok, out_scores, 0.0)[..., None],
                     torch.where(ok, labels.gather(1, kidx).float(), -1.0)[..., None]], -1)
    if kd < max_det:  # fewer candidates than max_det (small inputs): pad the fixed-shape output
        pad = torch.zeros(B, max_det - kd, 7, device=det.device)
        pad[..., -1] = -1.0
        det = torch.cat([det, pad], 1)
    return det
