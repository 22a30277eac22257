"""COCO bbox evaluation in numpy (the COCOeval protocol), for `val(save_json=True)`.

Counterpart of `lpc_yolo_tpu/utils/cocoeval.py` (`COCOEvaluator`,
`yolo_dataset_to_coco`, `eval_json`), kept as its own copy so the port imports
nothing of the JAX package. Per image and category, detections are matched
greedily in score order at 10 IoU thresholds, with crowd/ignore semantics,
area ranges, maxDets caps and 101-point interpolated precision;
`evaluate()` returns the 12 standard summary stats, of which stats[0] and
stats[1] are mAP50-95 and mAP50.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det boxes (D, 4) and gt boxes (G, 4), xywh top-left format.
    For crowd gts the denominator is the det area (maskUtils.iou semantics)."""
    d_x1, d_y1 = dets[:, 0], dets[:, 1]
    d_x2, d_y2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    g_x1, g_y1 = gts[:, 0], gts[:, 1]
    g_x2, g_y2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.minimum(d_x2[:, None], g_x2[None]) - np.maximum(d_x1[:, None], g_x1[None])
    ih = np.minimum(d_y2[:, None], g_y2[None]) - np.maximum(d_y1[:, None], g_y1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_d = (dets[:, 2] * dets[:, 3])[:, None]
    area_g = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """bbox COCOeval over in-memory annotation/prediction dicts.

    annotations: COCO dict with 'images', 'annotations', 'categories'.
    predictions: list of {'image_id', 'category_id', 'bbox' xywh, 'score'}.
    """

    def __init__(self, annotations: Dict, predictions: List[Dict]):
        self.img_ids = sorted({im["id"] for im in annotations.get("images", [])})
        self.cat_ids = sorted({c["id"] for c in annotations.get("categories", [])})
        if not self.img_ids:  # fall back to ids present in anns/preds
            self.img_ids = sorted(
                {a["image_id"] for a in annotations.get("annotations", [])}
                | {p["image_id"] for p in predictions}
            )
        if not self.cat_ids:
            self.cat_ids = sorted(
                {a["category_id"] for a in annotations.get("annotations", [])}
                | {p["category_id"] for p in predictions}
            )
        self._gts: Dict = {(i, c): [] for i in self.img_ids for c in self.cat_ids}
        self._dts: Dict = {(i, c): [] for i in self.img_ids for c in self.cat_ids}
        for a in annotations.get("annotations", []):
            key = (a["image_id"], a["category_id"])
            if key in self._gts:
                self._gts[key].append(a)
        for p in predictions:
            key = (p["image_id"], p["category_id"])
            if key in self._dts:
                self._dts[key].append(p)
        self.stats: Optional[np.ndarray] = None

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts, dts = self._gts[(img_id, cat_id)], self._dts[(img_id, cat_id)]
        if not gts and not dts:
            return None
        g_ignore = np.array(
            [
                bool(g.get("iscrowd", 0))
                or bool(g.get("ignore", 0))
                or not (area_rng[0] <= g.get("area", g["bbox"][2] * g["bbox"][3]) <= area_rng[1])
                for g in gts
            ],
            bool,
        )
        # gts sorted: non-ignored first (pycocotools gtind ordering)
        order_g = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in order_g]
        g_ignore = g_ignore[order_g]
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gts], np.int32)
        dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
        D, G, T = len(dts), len(gts), len(IOU_THRS)
        if D and G:
            ious = _iou_xywh(
                np.array([d["bbox"] for d in dts], np.float64),
                np.array([g["bbox"] for g in gts], np.float64),
                iscrowd,
            )
        else:
            ious = np.zeros((D, G))
        dt_m = np.zeros((T, D), np.int64)  # matched gt index+1, 0 = unmatched
        gt_m = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best, m = min(thr, 1 - 1e-10), -1
                for g in range(G):
                    if gt_m[t, g] > 0 and not iscrowd[g]:
                        continue
                    # non-ignored matches exhausted: stop at first ignored gt
                    if m > -1 and not g_ignore[m] and g_ignore[g]:
                        break
                    if ious[d, g] < best:
                        continue
                    best, m = ious[d, g], g
                if m == -1:
                    continue
                dt_m[t, d] = m + 1
                gt_m[t, m] = d + 1
                dt_ig[t, d] = g_ignore[m]
        # unmatched dets outside the area range are ignored
        d_area_out = np.array(
            [not (area_rng[0] <= d["bbox"][2] * d["bbox"][3] <= area_rng[1]) for d in dts], bool
        )
        dt_ig |= (dt_m == 0) & d_area_out[None]
        return {
            "dt_scores": np.array([d["score"] for d in dts], np.float64),
            "dt_m": dt_m,
            "dt_ig": dt_ig,
            "num_gt": int((~g_ignore).sum()),
        }

    def evaluate(self) -> np.ndarray:
        """Returns the 12 standard stats; also stored on self.stats."""
        T, R, K = len(IOU_THRS), len(REC_THRS), len(self.cat_ids)
        A, M = len(AREA_RANGES), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        max_det_cap = max(MAX_DETS)
        for k, cat in enumerate(self.cat_ids):
            for a, rng in enumerate(AREA_RANGES.values()):
                evals = [self._evaluate_img(i, cat, rng, max_det_cap) for i in self.img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                for m, md in enumerate(MAX_DETS):
                    scores = np.concatenate([e["dt_scores"][:md] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dt_m"][:, :md] for e in evals], axis=1)[:, order]
                    dtig = np.concatenate([e["dt_ig"][:, :md] for e in evals], axis=1)[:, order]
                    n_gt = sum(e["num_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    tps = (dtm > 0) & ~dtig
                    fps = (dtm == 0) & ~dtig
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_cum[t], fp_cum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                        q = np.zeros(R)
                        # precision envelope (monotone non-increasing from right)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.precision, self.recall = precision, recall

        def _summ(iou=None, area="all", md=100, use_prec=True):
            a = list(AREA_RANGES).index(area)
            m = MAX_DETS.index(md)
            if use_prec:
                s = precision[:, :, :, a, m]
                if iou is not None:
                    s = s[[int(np.argwhere(np.isclose(IOU_THRS, iou))[0][0])]]
            else:
                s = recall[:, :, a, m]
                if iou is not None:
                    s = s[[int(np.argwhere(np.isclose(IOU_THRS, iou))[0][0])]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        self.stats = np.array(
            [
                _summ(),
                _summ(iou=0.5),
                _summ(iou=0.75),
                _summ(area="small"),
                _summ(area="medium"),
                _summ(area="large"),
                _summ(md=1, use_prec=False),
                _summ(md=10, use_prec=False),
                _summ(md=100, use_prec=False),
                _summ(area="small", use_prec=False),
                _summ(area="medium", use_prec=False),
                _summ(area="large", use_prec=False),
            ]
        )
        return self.stats


def yolo_dataset_to_coco(dataset) -> Dict:
    """Build an in-memory COCO annotation dict from a YOLODataset (original
    image space), for rescoring when no instances_val JSON exists."""
    images, annotations = [], []
    ann_id = 1
    cat_ids = set()
    for i in range(len(dataset)):
        item = dataset.get_item_raw(i)
        h0, w0 = item["img"].shape[:2]
        stem = Path(item["path"]).stem
        image_id = int(stem) if stem.isnumeric() else stem
        images.append({"id": image_id, "width": w0, "height": h0})
        for c, b in zip(item["cls"], item["bboxes"]):  # normalized xywh center
            x = (b[0] - b[2] / 2) * w0
            y = (b[1] - b[3] / 2) * h0
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": image_id,
                    "category_id": int(c),
                    "bbox": [float(x), float(y), float(b[2] * w0), float(b[3] * h0)],
                    "area": float(b[2] * w0 * b[3] * h0),
                    "iscrowd": 0,
                }
            )
            cat_ids.add(int(c))
            ann_id += 1
    categories = [{"id": c, "name": str(c)} for c in sorted(cat_ids)]
    return {"images": images, "annotations": annotations, "categories": categories}


def eval_json(
    pred_json: Union[str, Path, List[Dict]],
    anno_json: Union[str, Path, Dict],
    img_ids: Optional[Sequence] = None,
) -> Dict[str, float]:
    """Reference eval_json analog: COCO-rescore a predictions dump.

    Returns {'mAP50-95': stats[0], 'mAP50': stats[1], ...} per the standard
    summary. img_ids optionally restricts evaluation (detect/val.py:291).
    """
    preds = json.loads(Path(pred_json).read_text()) if isinstance(pred_json, (str, Path)) else pred_json
    anno = json.loads(Path(anno_json).read_text()) if isinstance(anno_json, (str, Path)) else anno_json
    ev = COCOEvaluator(anno, preds)
    if img_ids is not None:
        ev.img_ids = sorted(set(img_ids) & set(ev.img_ids)) or sorted(img_ids)
    stats = ev.evaluate()
    keys = [
        "mAP50-95", "mAP50", "mAP75", "mAP-small", "mAP-medium", "mAP-large",
        "AR1", "AR10", "AR100", "AR-small", "AR-medium", "AR-large",
    ]
    return dict(zip(keys, stats.tolist()))
