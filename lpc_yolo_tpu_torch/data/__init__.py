"""Data of the port: dataset YAMLs, YOLO-format labels, cv2's image ops on tensors,
the training and validation transforms, the seeded loader and a synthetic dataset."""

from .augment import (OBBTrainTransforms, PoseTrainTransforms, SegTrainTransforms, TrainTransforms, ValTransforms,
                      render, xywhn_to_xyxy)
from .build import DataLoader, collate
from .dataset import IMG_SUFFIXES, YOLODataset, check_det_dataset, img2label_path
from .synthetic import make_synthetic_dataset

__all__ = ["IMG_SUFFIXES", "YOLODataset", "check_det_dataset", "img2label_path", "TrainTransforms", "SegTrainTransforms",
           "PoseTrainTransforms", "OBBTrainTransforms",
           "ValTransforms", "render", "xywhn_to_xyxy", "DataLoader", "collate", "make_synthetic_dataset"]
