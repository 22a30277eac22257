"""Data of the port: dataset YAMLs, YOLO-format labels, validation transforms and the loader."""

from .augment import ValTransforms, xywhn_to_xyxy
from .build import DataLoader, collate
from .dataset import IMG_SUFFIXES, YOLODataset, check_det_dataset, img2label_path

__all__ = ["IMG_SUFFIXES", "YOLODataset", "check_det_dataset", "img2label_path", "ValTransforms", "xywhn_to_xyxy",
           "DataLoader", "collate"]
