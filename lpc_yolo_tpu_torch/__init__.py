"""PyTorch/CUDA port of lpc_yolo_tpu: detection and instance segmentation, serving and training, on an NVIDIA H100.

The JAX package `lpc_yolo_tpu` stays the reference; this package imports
nothing of it (nor of jax/flax). Entry points run on CUDA unless the caller
passes device="cpu"; the hand-written kernels live under `csrc/` and are
built with nvcc at first use (see `ops/_build.py`).
"""

from .engine.model import YOLO, YOLOWorld
from .engine.results import Boxes, Results
from .nn.compiler import DetectionModel, build_model

__all__ = ["YOLO", "YOLOWorld", "Results", "Boxes", "DetectionModel", "build_model"]
