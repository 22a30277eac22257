"""Tensor ops of the port: anchors, boxes, instance masks (`masks.py`) and the six
hand-written kernels' wrappers (letterbox, conv3x3, repack, nms, conv_s8, quantize_s8), each beside
its plain PyTorch version."""

from .conv3x3 import conv3x3, conv3x3_plain
from .conv_s8 import conv_s8, conv_s8_plain
from .letterbox import build_letterbox_mats, letterbox, letterbox_geometry, letterbox_plain, letterbox_tables
from .nms import nms_greedy, nms_plain, non_max_suppression
from .quantize_s8 import quantize_s8, quantize_s8_plain
from .repack import pack_width, repack_width, repack_width_kernel, repack_width_plain, unpack_width

__all__ = [
    "conv3x3", "conv3x3_plain", "conv_s8", "conv_s8_plain", "quantize_s8", "quantize_s8_plain",
    "letterbox", "letterbox_plain", "letterbox_tables", "letterbox_geometry", "build_letterbox_mats",
    "pack_width", "unpack_width", "repack_width", "repack_width_kernel", "repack_width_plain",
    "nms_greedy", "nms_plain", "non_max_suppression",
]
