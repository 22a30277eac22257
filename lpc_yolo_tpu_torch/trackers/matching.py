"""Association costs and the assignment of the trackers (counterpart of
`lpc_yolo_tpu/trackers/matching.py:17-71`).

`linear_assignment` is scipy's `linear_sum_assignment` with the pairs above the
threshold rejected; equal costs resolve in scipy's order, so `iou_distance`
(1 - IoU through `utils/metrics.py::box_iou_np`, f32), `fuse_score` and
`embedding_distance` keep the JAX package's operations and dtypes, and their
costs are bitwise the JAX ones.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..utils.metrics import box_iou_np


def linear_assignment(cost_matrix: np.ndarray, thresh: float) -> Tuple[np.ndarray, List[int], List[int]]:
    """Hungarian match; pairs with cost > thresh are rejected.

    Returns (matches (K,2), unmatched_a, unmatched_b).
    """
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            list(range(cost_matrix.shape[0])),
            list(range(cost_matrix.shape[1])),
        )
    from scipy.optimize import linear_sum_assignment

    # guard against inf rows making the problem infeasible
    cost = np.where(np.isfinite(cost_matrix), cost_matrix, 1e6)
    rows, cols = linear_sum_assignment(cost)
    matches = [(r, c) for r, c in zip(rows, cols) if cost_matrix[r, c] <= thresh]
    matched_a = {m[0] for m in matches}
    matched_b = {m[1] for m in matches}
    unmatched_a = [i for i in range(cost_matrix.shape[0]) if i not in matched_a]
    unmatched_b = [i for i in range(cost_matrix.shape[1]) if i not in matched_b]
    return np.array(matches, dtype=int).reshape(-1, 2), unmatched_a, unmatched_b


def iou_distance(atracks: list, btracks: list) -> np.ndarray:
    """1 - IoU cost between two track/detection lists (matching.py:60)."""
    a_boxes = np.array([t.xyxy for t in atracks], np.float32).reshape(-1, 4)
    b_boxes = np.array([t.xyxy for t in btracks], np.float32).reshape(-1, 4)
    if len(a_boxes) == 0 or len(b_boxes) == 0:
        return np.ones((len(atracks), len(btracks)), np.float32)
    return 1.0 - box_iou_np(a_boxes, b_boxes)


def fuse_score(cost_matrix: np.ndarray, detections: list) -> np.ndarray:
    """Multiply IoU similarity by detection scores (matching.py fuse_score)."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1.0 - cost_matrix
    det_scores = np.array([d.score for d in detections])
    fused = iou_sim * det_scores[None, :]
    return 1.0 - fused


def embedding_distance(tracks: list, detections: list, metric: str = "cosine") -> np.ndarray:
    """Appearance cost from ReID features (matching.py embedding_distance)."""
    cost = np.zeros((len(tracks), len(detections)), np.float32)
    if cost.size == 0:
        return cost
    det_feats = np.array([d.curr_feat for d in detections], np.float32)
    trk_feats = np.array([t.smooth_feat for t in tracks], np.float32)
    if metric == "cosine":
        a = trk_feats / (np.linalg.norm(trk_feats, axis=1, keepdims=True) + 1e-12)
        b = det_feats / (np.linalg.norm(det_feats, axis=1, keepdims=True) + 1e-12)
        cost = 1.0 - a @ b.T
    return np.maximum(0.0, cost)
