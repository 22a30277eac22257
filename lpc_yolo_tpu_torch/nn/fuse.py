"""Conv+BN folding for serving (counterpart of `lpc_yolo_tpu/nn/fuse.py`:
`fuse_conv_bn` and `fold_preprocess`).

The JAX package folds as a variables transform; here each ConvBN keeps its
conv/bn parameters untouched (the state_dict does not change) and caches its
folded (W, b) once, at predictor build. Eval-mode forwards then run the
folded path: the 3x3 s1 g1 convs through the conv3x3 kernel, the rest
through F.conv2d. The predictor folds its own serving copy of the model, so
the caller's model keeps running conv -> BN -> act.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .modules import ConvBN, ResNetLayer


def fuse_conv_bn(model: nn.Module, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Fold every ConvBN of `model` in place; the folded weights are stored in `dtype`."""
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.fold(dtype)
    return model


def fold_preprocess(model: nn.Module, dtype: torch.dtype = torch.float32, scale: float = 1.0 / 255.0) -> nn.Module:
    """Fold the input normalisation x * scale into the first conv (JAX :68): conv(x * s, W)
    == conv(x, W * s), so the model takes the raw 0..255 frame. In place, on a folded model.

    Unlike the JAX package, whose feed is BGR, the channels are not permuted: the
    letterbox kernel already writes RGB. A ResNet stem (`ResNetLayer` with is_first) takes the
    scale in its 7x7 ConvBN, the first op it runs; the JAX predictor normalises the frame
    explicitly there (`engine/predictor.py:150-159`), which is the same function.
    """
    stem = model.model[0]
    if isinstance(stem, ResNetLayer) and stem.is_first:
        stem = stem.layer[0]
    if not isinstance(stem, ConvBN):
        raise ValueError(f"fold_preprocess needs a Conv stem, not {type(stem).__name__}")
    stem.fold(dtype, in_scale=scale)
    return model
