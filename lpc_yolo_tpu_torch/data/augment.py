"""Validation transforms (counterpart of `lpc_yolo_tpu/data/augment.py`:
`xywhn_to_xyxy` and `ValTransforms`).

The JAX validator letterboxes each frame on the host with cv2 (`scaleup=False`).
The port letterboxes on the card (`ops/letterbox.py`, the letterbox kernel), so
`ValTransforms` hands on the raw BGR frame with the geometry that letterbox
will apply, `letterbox_geometry(scaleup=False)`, and the ground truth in
letterbox pixels, padded to `max_gt` rows with a mask, as the JAX package
computes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.letterbox import letterbox_geometry


def xywhn_to_xyxy(bboxes: np.ndarray, w: float, h: float, padw: float = 0, padh: float = 0) -> np.ndarray:
    out = np.empty_like(bboxes)
    out[:, 0] = w * (bboxes[:, 0] - bboxes[:, 2] / 2) + padw
    out[:, 1] = h * (bboxes[:, 1] - bboxes[:, 3] / 2) + padh
    out[:, 2] = w * (bboxes[:, 0] + bboxes[:, 2] / 2) + padw
    out[:, 3] = h * (bboxes[:, 1] + bboxes[:, 3] / 2) + padh
    return out


class ValTransforms:
    """The raw frame, the letterbox geometry for unscaling, and the padded ground truth."""

    def __init__(self, imgsz: int = 640, max_gt: int = 128):
        self.imgsz = imgsz
        self.max_gt = max_gt

    def __call__(self, dataset, idx: int) -> Dict:
        item = dataset.get_item_raw(idx)
        img0 = item["img"]
        h0, w0 = img0.shape[:2]
        gain, _, pad = letterbox_geometry((h0, w0), (self.imgsz, self.imgsz), scaleup=False)
        boxes = xywhn_to_xyxy(item["bboxes"], w0 * gain, h0 * gain, pad[0], pad[1])
        M = self.max_gt
        n = min(len(boxes), M)
        out_boxes = np.zeros((M, 4), np.float32)
        out_cls = np.zeros((M,), np.int32)
        mask = np.zeros((M,), bool)
        out_boxes[:n] = boxes[:n]
        out_cls[:n] = item["cls"][:n]
        mask[:n] = True
        return {
            "img": img0,
            "cls": out_cls,
            "bboxes": out_boxes,
            "mask": mask,
            "orig_shape": (h0, w0),
            "gain": gain,
            "pad": pad,
            "path": item["path"],
        }
