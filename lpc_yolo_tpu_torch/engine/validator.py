"""Validator: dataset -> device letterbox -> the model graph -> decode -> TP matching -> mAP.

Counterpart of `lpc_yolo_tpu/engine/validator.py::Validator` for the v10,
v8, segment, pose and OBB tasks (`__init__` :34-71, the v10, v8, segment,
pose and OBB predicts of `_make_predict`, `_gt_masks` :155-172, `_gt_kpts`
:175-186, `_gt_rboxes` :188-200, `__call__` :202-362, `_to_coco_json`
:364-382). A Detect (v8) model decodes through
`non_max_suppression` at `conf`, `iou` and one candidate per (anchor, class)
(`multi_label`, :148-150), its greedy loop one launch of the NMS kernel per
batch; matching, metrics and COCO rescoring are the same for both.

Per batch, on the device: the frames of each shape are copied from pinned
memory and letterboxed into the batch by one launch of the letterbox kernel
with the validator's geometry (`scaleup=False`), as uint8, so the model sees
the rounded 0..255 frame the JAX validator gets from cv2; then a cast to the
validator's dtype and the BN-folded serving copy of the model, /255 folded
into its stem as the JAX validator folds it (:93-96; its 3x3 s1 convs
through the conv3x3 kernel) and the decode, `(B, 300, 6)` in letterbox
pixels, copied to the host once. On the host, as the JAX package
does: rows above `conf`, matching at 10 IoUs in letterbox space (IoU does not
change under the letterbox's uniform scale and shift), the confusion matrix
and the metrics.

A Segment model is matched twice (:287-294, :330-339): by box IoU, and by
mask IoU for the `(M)` metrics. Each kept row's mask is `process_mask(...,
upsample=True) > 0.5` at imgsz, decoded on the device for the rows above
`conf` only (the JAX validator decodes all `max_det` rows; the others are
never read, so the values agree); the ground truth's polygons are filled at
letterbox resolution by `ops/masks.py::fill_poly` (cv2.fillPoly bit for
bit) on the host, and the mask IoU is one matmul on the device
(`utils/metrics.py::mask_iou`, exact). `fitness` stays the box fitness, as the
JAX validator leaves out the mask one.

A Pose model is matched twice as well (:296-309, :329-341): by box IoU, and
by OKS (`utils/metrics.py::kpt_iou_np`, the JAX numpy) for the `(P)` keys:
each kept row's keypoints, gathered by its anchor, against the ground
truth's in letterbox pixels, the area the GT box's times 0.53, the sigmas
`OKS_SIGMA[:K]`. Like the masks, only the GT rows the box labels keep (the
first max_gt) are read: the JAX `_gt_kpts` reads every row, so past max_gt
its OKS matrix no longer matches the box rows and `kpt_iou_np` raises. A
keypoint set of ndim 2 raises NotImplementedError: the JAX `kpt_iou_np`
reads the visibility column (`utils/metrics.py:306`), which such a set
lacks. `fitness` stays the box fitness.

An OBB model (:110-127, :273-279) decodes through `nms_rotated` with one
candidate per (anchor, class); each kept row is [its rotated box's hull,
conf, cls] for the confusion matrix, and rows are matched to the ground
truth by probIoU (`utils/metrics.py::probiou_matrix_np`, the JAX numpy) of
the rotated boxes in letterbox pixels (`ValTransforms`). The results carry
the box keys only, as in the JAX package. The JAX `_gt_rboxes` reads every
label row while the labels keep the first max_gt; here only the kept rows
are read, and the rotated boxes come from the quads in pixels
(`data/dataset.py::rotated_boxes`).

A World model reads the facade's text table `txt_feats` (1, M, 512), broadcast
to each batch, and its M classes must be the dataset's nc. The JAX validator
passes no text (:99), so its World graph scores every class alike, whatever
`set_classes` set (ROADMAP Queue 3); with a zero table the two agree.

`speed` holds the seconds spent in each part, summed over the run as in the
JAX package: "preprocess" is the host's time to copy and enqueue the
letterbox, "inference" runs until the detections are on the host (so it holds
the device's letterbox and forward), "postprocess" is the host's matching.
Reading and transforming the images (the loader) is in none of them.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data import DataLoader, ValTransforms, YOLODataset, check_det_dataset
from ..losses.pose import OKS_SIGMA
from ..ops.boxes import rbox_hull
from ..ops.masks import fill_poly, process_kept_rows
from ..utils import resolve_device
from ..utils.metrics import (ConfusionMatrix, DetMetrics, box_iou_np, kpt_iou_np, mask_iou, match_predictions,
                             probiou_matrix_np)
from .predictor import letterbox_batch, serving_model


class Validator:
    def __init__(
        self,
        yolo,
        imgsz: int = 640,
        batch: int = 8,
        conf: float = 0.001,
        iou: float = 0.7,
        max_det: int = 300,
        max_gt: int = 128,
        workers: int = 4,
        save_json: bool = False,
        save_dir: Optional[str] = None,
        anno_json: Optional[str] = None,
        cache_images: Union[bool, str] = False,
        device: Union[str, torch.device, None] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        self.yolo = yolo
        self.imgsz = imgsz
        self.batch = batch
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.max_gt = max_gt
        self.workers = workers
        self.save_json = save_json
        self.anno_json = anno_json
        self.save_dir = Path(save_dir) if save_dir else None
        self.cache_images = cache_images
        self.device = resolve_device(device)
        # bf16 on the card, f32 on the CPU unless the caller says otherwise
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self.text = None  # a World model's text table on the device, set by __call__

    def preprocess(self, frames: List[np.ndarray]) -> torch.Tensor:
        """The frames letterboxed on the device, (n, S, S, 3) uint8 RGB."""
        return letterbox_batch(frames, self.imgsz, self.device, torch.uint8, scaleup=False)

    @torch.inference_mode()
    def predict(self, model, x: torch.Tensor):
        """(n, max_det, 6) detections in letterbox pixels, f32, on the host; for a segment model with
        the detections on the device, the rows' mask coefficients and the prototypes; for a pose model
        with the rows' keypoints (n, max_det, nk) on the host; for an OBB model [hull, conf, cls] rows and
        the rotated boxes (n, max_det, 5) on the host."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        text = None if self.text is None else self.text.expand(x.shape[0], -1, -1)
        out = model.predict(x, self.max_det, self.conf, self.iou, multi_label=True, text=text)
        if model.task == "obb":
            det = torch.cat([rbox_hull(out[..., :5]), out[..., 5:7]], -1)
            return det.cpu().numpy(), out[..., :5].cpu().numpy()
        if model.task == "pose":
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        if isinstance(out, tuple):
            return (out[0].cpu().numpy(), *out)
        return out.cpu().numpy()

    def gt_masks(self, dataset, ds_idx: int, batch: Dict, j: int) -> np.ndarray:
        """The ground truth's polygons filled at letterbox resolution, (n, imgsz, imgsz) uint8, in the JAX
        validator's f32 arithmetic (:155-172). Unlike the JAX validator, only the rows the box labels keep
        (the first max_gt), and a box row's empty polygon gives an empty mask (cv2.fillPoly raises on it)."""
        segs = dataset.labels[ds_idx].get("segments", [])[: int(batch["mask"][j].sum())]
        h0, w0 = batch["orig_shape"][j]
        gain = float(batch["gain"][j])
        out = np.zeros((len(segs), self.imgsz, self.imgsz), np.uint8)
        for i, poly in enumerate(segs):
            p = np.asarray(poly, np.float32) * np.array([w0 * gain, h0 * gain], np.float32)
            p += np.asarray(batch["pad"][j], np.float32)
            fill_poly(out[i], p.astype(np.int32))
        return out

    def gt_kpts(self, dataset, ds_idx: int, batch: Dict, j: int) -> np.ndarray:
        """The ground truth's keypoints in letterbox pixels, (n, K, 3) f32, in the JAX validator's f32
        arithmetic (:175-186), of the rows the box labels keep (the first max_gt) only."""
        k = np.asarray(dataset.labels[ds_idx].get("keypoints", np.zeros((0, 17, 3))), np.float32)
        k = k[: int(batch["mask"][j].sum())].copy()
        if len(k) == 0:
            return k
        h0, w0 = batch["orig_shape"][j]
        gain = float(batch["gain"][j])
        pad = batch["pad"][j]
        k[..., 0] = k[..., 0] * (w0 * gain) + float(pad[0])
        k[..., 1] = k[..., 1] * (h0 * gain) + float(pad[1])
        return k

    @torch.inference_mode()
    def mask_ious(self, gt: np.ndarray, det: torch.Tensor, mc: torch.Tensor, proto: torch.Tensor,
                  keep: np.ndarray) -> np.ndarray:
        """(n_gt, n_kept) mask IoU of one image: its kept rows' masks decoded on the device at imgsz."""
        if len(gt) == 0 or not keep.any():
            return np.zeros((len(gt), int(keep.sum())), np.float32)
        pred = process_kept_rows(proto, mc, det, keep, self.imgsz) > 0.5
        return mask_iou(torch.from_numpy(gt).to(det.device), pred).cpu().numpy()

    def __call__(self, data, model: Optional[torch.nn.Module] = None) -> Dict[str, float]:
        """Validate `model` (the facade's model unless given: the trainer passes its EMA copy)
        on the `val` split of `data` (a dataset YAML or dict)."""
        info = check_det_dataset(data)
        model = self.yolo.model if model is None else model
        seg, pose = model.task == "segment", model.task == "pose"
        if pose and model.model[-1].kpt_shape[1] != 3:
            raise NotImplementedError(f"val of a kpt_shape {model.model[-1].kpt_shape} model is not ported: the JAX "
                                      f"kpt_iou_np reads a visibility column (lpc_yolo_tpu/utils/metrics.py:306)")
        if model.task == "world":
            text = np.asarray(self.yolo.txt_feats, np.float32)
            if text.shape[1] != info["nc"]:
                raise ValueError(f"the text table has {text.shape[1]} classes, the dataset {info['nc']}: call "
                                 f"set_classes with the dataset's names first")
            self.text = torch.from_numpy(text).to(self.device)
        dataset = YOLODataset(info["val"], cache_images=self.cache_images, kpt_shape=info.get("kpt_shape"),
                              obb=model.task == "obb")
        loader = DataLoader(dataset, ValTransforms(self.imgsz, self.max_gt), batch_size=self.batch,
                            workers=self.workers)
        model = serving_model(model, self.device, self.dtype)

        stats: Dict[str, List[np.ndarray]] = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        stats_x: Dict[str, List[np.ndarray]] = {k: [] for k in stats}  # the mask (segment) or OKS (pose) matching
        cm = ConfusionMatrix(nc=info["nc"], conf=self.conf)
        json_preds: List[Dict] = []
        seen = 0
        for batch in loader:
            t0 = time.perf_counter()
            x = self.preprocess(batch["img"])
            t1 = time.perf_counter()
            out = self.predict(model, x)  # (B, max_det, 6), and the seg decode's inputs or the keypoints
            det, extra = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
            t2 = time.perf_counter()
            n_real = det.shape[0] - batch["pad_count"]
            for j in range(n_real):
                keep = det[j][:, 4] > self.conf
                rows = det[j][keep]
                gt_boxes = batch["bboxes"][j][batch["mask"][j]]
                gt_cls = batch["cls"][j][batch["mask"][j]]
                if len(rows) == 0:
                    if len(gt_cls):
                        for st in (stats, stats_x) if seg or pose else (stats,):
                            st["tp"].append(np.zeros((0, len(self.iouv)), bool))
                            st["conf"].append(np.zeros(0))
                            st["pred_cls"].append(np.zeros(0))
                            st["target_cls"].append(gt_cls)
                        cm.process_batch(None, gt_boxes, gt_cls)
                    continue
                if model.task == "obb":  # rotated probIoU matching (reference obb/val.py _process_batch)
                    iou = probiou_matrix_np(batch["rboxes"][j][batch["mask"][j]], extra[0][j][keep])
                else:
                    iou = box_iou_np(gt_boxes, rows[:, :4])
                stats["tp"].append(match_predictions(rows[:, 5], gt_cls, iou, self.iouv))
                stats["conf"].append(rows[:, 4])
                stats["pred_cls"].append(rows[:, 5])
                stats["target_cls"].append(gt_cls)
                cm.process_batch(rows, gt_boxes, gt_cls)
                if seg:
                    det_dev, mc, proto = extra
                    iou_x = self.mask_ious(self.gt_masks(dataset, seen + j, batch, j), det_dev[j], mc[j], proto[j],
                                           keep)
                elif pose:
                    gt_k = self.gt_kpts(dataset, seen + j, batch, j)
                    nk = gt_k.shape[1] if len(gt_k) else 17
                    kd = (info.get("kpt_shape") or [17, 3])[1]
                    pk = extra[0][j][keep].reshape(len(rows), -1, kd)[:, :nk]
                    area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]) * 0.53
                    iou_x = kpt_iou_np(gt_k, pk, area, np.asarray(OKS_SIGMA[:nk]))
                if seg or pose:
                    stats_x["tp"].append(match_predictions(rows[:, 5], gt_cls, iou_x, self.iouv))
                    stats_x["conf"].append(rows[:, 4])
                    stats_x["pred_cls"].append(rows[:, 5])
                    stats_x["target_cls"].append(gt_cls)
                if self.save_json:
                    json_preds.extend(self._to_coco_json(rows, batch, j))
            seen += n_real
            t3 = time.perf_counter()
            self.speed["preprocess"] += t1 - t0
            self.speed["inference"] += t2 - t1
            self.speed["postprocess"] += t3 - t2

        metrics = DetMetrics(names=info["names"])
        if stats["tp"]:
            metrics.process(
                np.concatenate(stats["tp"]),
                np.concatenate(stats["conf"]),
                np.concatenate(stats["pred_cls"]),
                np.concatenate(stats["target_cls"]),
            )
        self.metrics = metrics
        self.confusion_matrix = cm
        results = metrics.results_dict()
        if stats_x["tp"]:  # the (M) or (P) keys (JAX :329-341): the second matches, without a fitness of their own
            mx = self.metrics_extra = DetMetrics(names=info["names"])
            mx.process(*(np.concatenate(stats_x[k]) for k in ("tp", "conf", "pred_cls", "target_cls")))
            sfx = "(M)" if seg else "(P)"
            results.update({k.replace("(B)", sfx): v for k, v in mx.results_dict().items() if k != "fitness"})
        if self.save_json and self.save_dir:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "predictions.json").write_text(json.dumps(json_preds))
        if self.save_json:
            # COCO rescoring against an instances_val JSON when the dataset has one, else its own labels
            from ..utils.cocoeval import eval_json, yolo_dataset_to_coco

            anno = self.anno_json
            if anno is None:
                cand = Path(info["path"]) / "annotations" / "instances_val2017.json"
                anno = str(cand) if cand.is_file() else yolo_dataset_to_coco(dataset)
            coco = eval_json(json_preds, anno)
            results["metrics/mAP50-95(COCO)"] = coco["mAP50-95"]
            results["metrics/mAP50(COCO)"] = coco["mAP50"]
            self.coco_stats = coco
        return results

    @staticmethod
    def _to_coco_json(rows: np.ndarray, batch: Dict, j: int) -> List[Dict]:
        """COCO-format rows: xywh with top-left origin, boxes unscaled to the original image."""
        gain, pad = batch["gain"][j], batch["pad"][j]
        image_id = Path(batch["path"][j]).stem
        image_id = int(image_id) if image_id.isnumeric() else image_id
        out = []
        for r in rows:
            b = (r[:4] - np.array([pad[0], pad[1], pad[0], pad[1]])) / gain
            out.append(
                {
                    "image_id": image_id,
                    "category_id": int(r[5]),
                    "bbox": [round(float(b[0]), 3), round(float(b[1]), 3), round(float(b[2] - b[0]), 3), round(float(b[3] - b[1]), 3)],
                    "score": round(float(r[4]), 5),
                }
            )
        return out
