"""Detection metrics: IoU matching at 10 thresholds, AP/mAP, P/R, confusion matrix (host numpy).

Counterpart of `lpc_yolo_tpu/utils/metrics.py` (`box_iou_np`, `match_predictions`,
`compute_ap`, `ap_per_class`, `smooth`, `DetMetrics`, `ConfusionMatrix`), kept
as its own copy so the port imports nothing of the JAX package; `mask_iou`
is `mask_iou_np` (:281-292) in torch, on the masks' device; `kpt_iou_np`
(:295-308), `probiou_np` (:30-55) and `probiou_matrix_np` (:311-320) are the
same numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N,4) x (M,4) xyxy -> (N,M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def mask_iou(gt: torch.Tensor, pred: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(M, N) IoU of (M, H, W) and (N, H, W) 0/1 masks (JAX `utils/metrics.py::mask_iou_np`), f32.

    One matmul of 0/1 f32 masks: every partial sum is an integer below 2**24, so each is
    exact and the result equals numpy's bit for bit, whatever order the product sums in."""
    g = gt.reshape(len(gt), -1).float()
    p = pred.reshape(len(pred), -1).float()
    inter = g @ p.T
    union = g.sum(1)[:, None] + p.sum(1)[None] - inter
    return inter / (union + eps)


def probiou_np(obb1: np.ndarray, obb2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Probabilistic IoU of rotated boxes (reference metrics.py:198-260), elementwise: obb1, obb2 (N, 5)
    [cx, cy, w, h, angle] -> (N,)."""

    def covariance(obb):
        w, h, r = obb[:, 2], obb[:, 3], obb[:, 4]
        a, b = (w ** 2) / 12.0, (h ** 2) / 12.0
        cos, sin = np.cos(r), np.sin(r)
        return a * cos ** 2 + b * sin ** 2, a * sin ** 2 + b * cos ** 2, (a - b) * cos * sin

    x1, y1 = obb1[:, 0], obb1[:, 1]
    x2, y2 = obb2[:, 0], obb2[:, 1]
    a1, b1, c1 = covariance(obb1)
    a2, b2, c2 = covariance(obb2)
    det = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2  # eps is added where the JAX numpy adds it, not in t3
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / (det + eps) * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / (det + eps) * 0.5
    t3 = np.log(det / (4 * np.sqrt(np.clip(a1 * b1 - c1 ** 2, 0, None) * np.clip(a2 * b2 - c2 ** 2, 0, None)) + eps)
                + eps) * 0.5
    bd = np.clip(t1 + t2 + t3, eps, 100.0)
    hd = np.sqrt(1.0 - np.exp(-bd) + eps)
    return 1 - hd


def probiou_matrix_np(obb1: np.ndarray, obb2: np.ndarray) -> np.ndarray:
    """Pairwise probIoU (M, 5) x (N, 5) -> (M, N), the OBB validator's match criterion (reference
    batch_probiou)."""
    m, n = len(obb1), len(obb2)
    if m == 0 or n == 0:
        return np.zeros((m, n), np.float32)
    return probiou_np(np.repeat(obb1, n, axis=0), np.tile(obb2, (m, 1))).reshape(m, n)


def kpt_iou_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, area: np.ndarray, sigmas: np.ndarray,
               eps: float = 1e-7) -> np.ndarray:
    """Object Keypoint Similarity (reference metrics.py:156 kpt_iou): gt (M, K, 3) with visibility, pred
    (N, K, 2+), area (M,) -> (M, N), over the visible ground-truth points."""
    if len(gt_kpts) == 0 or len(pred_kpts) == 0:
        return np.zeros((len(gt_kpts), len(pred_kpts)), np.float32)
    d = (gt_kpts[:, None, :, 0] - pred_kpts[None, :, :, 0]) ** 2 + (
        gt_kpts[:, None, :, 1] - pred_kpts[None, :, :, 1]
    ) ** 2  # (M, N, K)
    vis = gt_kpts[..., 2] != 0  # (M, K)
    e = d / (2 * np.asarray(sigmas)) ** 2 / (area[:, None, None] + eps) / 2
    return (np.exp(-e) * vis[:, None]).sum(-1) / (vis.sum(-1)[:, None] + eps)


def match_predictions(
    pred_classes: np.ndarray,  # (N,)
    true_classes: np.ndarray,  # (M,)
    iou: np.ndarray,  # (M, N) gt x pred IoU
    iouv: np.ndarray,  # (T,) thresholds
) -> np.ndarray:
    """Greedy TP matching at each IoU threshold (validator.py:226-260).

    Returns tp bool array (N, T).
    """
    correct = np.zeros((pred_classes.shape[0], iouv.shape[0]), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]  # (M, N)
    iou = iou * correct_class
    for i, threshold in enumerate(iouv):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T  # (K, 2) [gt, pred]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
                matches = matches[order]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP for one class/IoU (metrics.py:498-530)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (N, T) bool
    conf: np.ndarray,  # (N,)
    pred_cls: np.ndarray,  # (N,)
    target_cls: np.ndarray,  # (M,)
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """Per-class AP over IoU thresholds (metrics.py:532-620 semantics)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    T = tp.shape[1] if tp.ndim > 1 else 1

    ap = np.zeros((nc, T))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    x = np.linspace(0, 1, 1000)

    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(T):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i_best = int(smooth(f1_curve.mean(0), 0.1).argmax())
    p, r, f1 = p_curve[:, i_best], r_curve[:, i_best], f1_curve[:, i_best]

    return {
        "ap": ap,  # (nc, T)
        "ap50": ap[:, 0],
        "p": p,
        "r": r,
        "f1": f1,
        "unique_classes": unique_classes.astype(int),
        "nt": nt,
        "p_curve": p_curve,
        "r_curve": r_curve,
    }


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


class DetMetrics:
    """Aggregates detect-task metrics (metrics.py:795-900)."""

    def __init__(self, names: Optional[Dict[int, str]] = None):
        self.names = names or {}
        self.stats: Dict[str, np.ndarray] = {}
        self.nt_per_class = None

    def process(self, tp, conf, pred_cls, target_cls):
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        self.stats = res
        self.nt_per_class = res["nt"]
        return self

    @property
    def ap_class_index(self):
        return self.stats.get("unique_classes", np.array([], int))

    @property
    def mp(self) -> float:
        return float(self.stats["p"].mean()) if len(self.stats.get("p", [])) else 0.0

    @property
    def mr(self) -> float:
        return float(self.stats["r"].mean()) if len(self.stats.get("r", [])) else 0.0

    @property
    def map50(self) -> float:
        ap = self.stats.get("ap")
        return float(ap[:, 0].mean()) if ap is not None and len(ap) else 0.0

    @property
    def map75(self) -> float:
        ap = self.stats.get("ap")
        return float(ap[:, 5].mean()) if ap is not None and len(ap) and ap.shape[1] > 5 else 0.0

    @property
    def map(self) -> float:
        ap = self.stats.get("ap")
        return float(ap.mean()) if ap is not None and len(ap) else 0.0

    @property
    def maps(self) -> np.ndarray:
        """Per-class mAP50-95 expanded over all classes."""
        nc = max(self.names) + 1 if self.names else (int(self.ap_class_index.max()) + 1 if len(self.ap_class_index) else 0)
        out = np.zeros(nc)
        ap = self.stats.get("ap")
        if ap is not None:
            for i, c in enumerate(self.ap_class_index):
                out[c] = ap[i].mean()
        return out

    @property
    def fitness(self) -> float:
        """0.9*mAP50-95 + 0.1*mAP50 (metrics.py fitness weights)."""
        return 0.1 * self.map50 + 0.9 * self.map

    def results_dict(self) -> Dict[str, float]:
        return {
            "metrics/precision(B)": self.mp,
            "metrics/recall(B)": self.mr,
            "metrics/mAP50(B)": self.map50,
            "metrics/mAP50-95(B)": self.map,
            "fitness": self.fitness,
        }


class ConfusionMatrix:
    """Task=detect confusion matrix (metrics.py:287-450)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = 0.25 if conf in (None, 0.001) else conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections: Optional[np.ndarray], gt_bboxes: np.ndarray, gt_cls: np.ndarray):
        """detections (N,6) [xyxy,conf,cls]; gts xyxy + cls."""
        if gt_cls.shape[0] == 0:
            if detections is not None:
                detections = detections[detections[:, 4] > self.conf]
                for dc in detections[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return

        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        detection_classes = detections[:, 5].astype(int)
        iou = box_iou_np(gt_bboxes, detections[:, :4])

        x = np.nonzero(iou > self.iou_thres)
        x = np.array(x).T
        if x.shape[0]:
            matches = np.concatenate([x, iou[x[:, 0], x[:, 1]][:, None]], 1)
            if x.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[detection_classes[m1[j]][0], gc] += 1  # correct-ish
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(detection_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # background FP
