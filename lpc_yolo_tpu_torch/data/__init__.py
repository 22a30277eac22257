"""Data of the port: dataset YAMLs, YOLO-format labels, class-folder sets, cv2's image ops on tensors,
the training and validation transforms, the seeded loader and a synthetic dataset."""

from .augment import (OBBTrainTransforms, PoseTrainTransforms, SegTrainTransforms, TrainTransforms, ValTransforms,
                      render, xywhn_to_xyxy)
from .build import DataLoader, collate
from .classify import ClassificationDataset, ClsTransforms, check_cls_dataset
from .dataset import IMG_SUFFIXES, YOLODataset, check_det_dataset, img2label_path
from .synthetic import make_cls_dataset, make_synthetic_dataset

__all__ = ["ClassificationDataset", "ClsTransforms", "check_cls_dataset", "IMG_SUFFIXES", "YOLODataset",
           "check_det_dataset", "img2label_path", "TrainTransforms", "SegTrainTransforms", "PoseTrainTransforms",
           "OBBTrainTransforms",
           "ValTransforms", "render", "xywhn_to_xyxy", "DataLoader", "collate", "make_cls_dataset",
           "make_synthetic_dataset"]
