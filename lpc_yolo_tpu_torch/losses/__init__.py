"""Training losses of the port: the v8 branch loss, the v10 dual-assignment loss, the v8 segmentation,
pose and oriented-box losses, the assigner, and RT-DETR's DETR loss."""

from .detection import LossItems, v8_detection_loss, v10_detect_loss
from .detr import rtdetr_loss
from .obb import v8_obb_loss
from .pose import OKS_SIGMA, v8_pose_loss
from .segment import v8_segmentation_loss
from .tal import AssignResult, task_aligned_assigner

__all__ = ["LossItems", "v8_detection_loss", "v10_detect_loss", "v8_segmentation_loss", "v8_pose_loss", "OKS_SIGMA",
           "v8_obb_loss", "rtdetr_loss", "AssignResult", "task_aligned_assigner"]
