"""Small helpers shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the CPU.

    Raises when CUDA is wanted and there is no card, so a run never carries on
    quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def require_cv2(feature: str):
    """OpenCV, for the features that draw or write media with it (plotting, `Results.save`, the save
    family's images and videos, video files, GMC's motion estimates); an ImportError that names the
    feature when it is not installed, as on the machine with the card. Nothing falls back without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{feature} needs OpenCV (cv2), which is not installed") from e
    return cv2
