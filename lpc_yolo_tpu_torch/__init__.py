"""PyTorch/CUDA port of lpc_yolo_tpu: detection and instance segmentation, serving and training, on an NVIDIA H100.

The JAX package `lpc_yolo_tpu` stays the reference; this package imports
nothing of it (nor of jax/flax). Entry points run on CUDA unless the caller
passes device="cpu"; the hand-written kernels live under `csrc/` and are
built with nvcc at first use (see `ops/_build.py`).
"""

__version__ = "0.1.0"

from .engine.model import YOLO, YOLOWorld  # noqa: E402
from .engine.results import Boxes, Results  # noqa: E402
from .nn.compiler import DetectionModel, build_model  # noqa: E402

__all__ = ["YOLO", "YOLOWorld", "Results", "Boxes", "DetectionModel", "build_model", "__version__"]
