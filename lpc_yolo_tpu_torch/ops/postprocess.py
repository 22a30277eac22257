"""The NMS-free decode of a v10 one-to-one head, as plain functions on tensors (counterpart of
`lpc_yolo_tpu/ops/postprocess.py::v10_postprocess` :27 and `v10_detections` :67).

Two top-k stages: the k1 = min(max_det, A) anchors of highest best-class score, then the k2 best of
their (anchor, class) pairs, padded with zero rows to max_det. Both rankings are `nms.top_k`'s, in
`lax.top_k`'s order (ties to the lower index), so tied scores pick the JAX rows. The serving graph
decodes through `nn/heads.py::decode_feats_topk_split`; these take a head's (B, A, 4 + nc) output.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .boxes import xywh2xyxy
from .nms import top_k


def v10_postprocess(preds: torch.Tensor, max_det: int = 300, nc: int = 80, rank: Callable = top_k
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, A, 4 + nc) xywh boxes and sigmoid scores -> boxes (B, max_det, 4) xywh, scores (B, max_det)
    and labels (B, max_det) int32. `rank(x, k)` gives the k largest of each row and their indices: `top_k`, or in an
    export graph `torch.topk`, an ONNX TopK of K = k (OpenCV 4.13's TopK refuses a K equal to the row, which a
    stable sort of the whole row would need)."""
    if preds.shape[-1] != 4 + nc:
        raise ValueError(f"expected {4 + nc} columns, got {preds.shape[-1]}")
    boxes, scores = preds[..., :4], preds[..., 4:]
    B, A = preds.shape[:2]
    k1 = min(max_det, A)
    _, index = rank(scores.amax(-1), k1)
    boxes = boxes.gather(1, index[..., None].expand(B, k1, 4))
    scores = scores.gather(1, index[..., None].expand(B, k1, nc))
    flat = scores.reshape(B, -1)
    k2 = min(max_det, flat.shape[-1])
    scores, index = rank(flat, k2)
    # truncating, as lax.rem / lax.div: equal to % and // on these non-negative indices, and each one ONNX op
    labels, anchor = torch.fmod(index, nc), torch.div(index, nc, rounding_mode="trunc")
    boxes = boxes.gather(1, anchor[..., None].expand(B, k2, 4))
    if k2 < max_det:  # zero rows up to the fixed shape
        pad = max_det - k2
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
    return boxes, scores, labels.to(torch.int32)


def v10_detections(preds: torch.Tensor, max_det: int = 300, nc: int = 80, rank: Callable = top_k) -> torch.Tensor:
    """`v10_postprocess` packed as (B, max_det, 6) rows [x1, y1, x2, y2, score, label]."""
    boxes, scores, labels = v10_postprocess(preds, max_det, nc, rank)
    return torch.cat([xywh2xyxy(boxes), scores[..., None], labels[..., None].to(boxes.dtype)], -1)
