"""Conv+BN folding for serving (counterpart of `lpc_yolo_tpu/nn/fuse.py`:
`fuse_conv_bn` and `fold_preprocess`).

The JAX package folds as a variables transform; here each ConvBN keeps its
conv/bn parameters untouched (the state_dict does not change) and caches its
folded (W, b) once, at predictor build. Eval-mode forwards then run the
folded path: the 3x3 s1 g1 convs through the conv3x3 kernel, the rest
through F.conv2d. A RepConv folds its 3x3, 1x1 and identity branches into
one such conv (the JAX package serves the branches: the same function). The
predictor folds its own serving copy of the model, so the caller's model
keeps running conv -> BN -> act.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .modules import BiasConv, ConvBN, HGStem, RepConv, ResNetLayer


def folded_convs(model: nn.Module) -> List[nn.Module]:
    """The modules `fuse_conv_bn` folds, in module order: every RepConv and BiasConv, and every ConvBN that is not
    a branch of a RepConv (a RepConv runs its own fold, never its branches')."""
    branches = {id(c) for m in model.modules() if isinstance(m, RepConv) for c in (m.conv1, m.conv2)}
    return [m for m in model.modules()
            if isinstance(m, (RepConv, BiasConv)) or isinstance(m, ConvBN) and id(m) not in branches]


def conv3x3_sites(model: nn.Module) -> List[nn.Module]:
    """The modules that run a conv3x3 site once folded (3x3 stride 1 groups 1), in module order."""
    return [m for m in folded_convs(model) if m.kernel_path]


def fuse_conv_bn(model: nn.Module, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Fold every ConvBN and RepConv of `model` in place; the folded weights are stored in `dtype`."""
    for m in folded_convs(model):
        m.fold(dtype)
    return model


def frame_readers(model: nn.Module) -> List[nn.Module]:
    """The layers that read the frame: layer 0, or, where layer 0 is a `Silence` (yolov9e), every layer that
    reads its output (yolov9e's layers 1 and 15), through any chain of Silences."""
    frame, readers = {-1}, []  # -1: the graph's input
    for spec in model.specs:
        inputs = {spec.i - 1 if j == -1 else j for j in spec.f}
        if not inputs & frame:
            continue
        if spec.module == "Silence":
            frame.add(spec.i)
        else:
            readers.append(model.model[spec.i])
    return readers


def fold_preprocess(model: nn.Module, dtype: torch.dtype = torch.float32, scale: float = 1.0 / 255.0) -> nn.Module:
    """Fold the input normalisation x * scale into every conv that reads the frame (JAX :68): conv(x * s, W)
    == conv(x, W * s), so the model takes the raw 0..255 frame. In place, on a folded model.

    Unlike the JAX package, whose feed is BGR, the channels are not permuted: the
    letterbox kernel already writes RGB. A ResNet stem (`ResNetLayer` with is_first) takes the
    scale in its 7x7 ConvBN, the first op it runs, and an `HGStem` (rtdetr-l, -x) in its stem1;
    the JAX predictor normalises the frame explicitly there (`engine/predictor.py:150-159`),
    which is the same function. Where the frame
    reaches convs through a `Silence` (yolov9e), each of them takes the scale; the JAX predictor
    divides by 255 on the device there (:143-151), the same function. A research-zoo stem (Swin's and FasterNet's
    patch embeddings, ConvNeXt's stem, CBRM, `stem`, Conv_BN_HSwish, mn_conv) takes it in the conv it names
    `frame_conv`; a LayerNorm or BatchNorm after that conv sees the same values. A frame reader that is not a ConvBN
    or a BiasConv raises.
    """
    for stem in frame_readers(model):
        if isinstance(stem, ResNetLayer) and stem.is_first:
            stem = stem.layer[0]
        elif isinstance(stem, HGStem):
            stem = stem.stem1
        elif hasattr(stem, "frame_conv"):  # a research-zoo stem: its one conv that reads the frame
            stem = stem.frame_conv
        if not isinstance(stem, (ConvBN, BiasConv)):
            raise ValueError(f"fold_preprocess needs a Conv stem, not {type(stem).__name__}")
        stem.fold(dtype, in_scale=scale)
    return model
