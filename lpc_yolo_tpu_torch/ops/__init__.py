"""Tensor ops of the port: anchors, boxes, instance masks (`masks.py`) and the four
hand-written kernels' wrappers (letterbox, conv3x3, repack, nms), each beside its plain
PyTorch version."""

from .conv3x3 import conv3x3, conv3x3_plain
from .letterbox import build_letterbox_mats, letterbox, letterbox_geometry, letterbox_plain, letterbox_tables
from .nms import nms_greedy, nms_plain, non_max_suppression
from .repack import pack_width, repack_width, repack_width_kernel, repack_width_plain, unpack_width

__all__ = [
    "conv3x3", "conv3x3_plain",
    "letterbox", "letterbox_plain", "letterbox_tables", "letterbox_geometry", "build_letterbox_mats",
    "pack_width", "unpack_width", "repack_width", "repack_width_kernel", "repack_width_plain",
    "nms_greedy", "nms_plain", "non_max_suppression",
]
