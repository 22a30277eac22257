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

from typing import List, NamedTuple

import torch
import torch.nn as nn

from ..ops.conv_s8 import check_geometry
from .modules import C2f, SPPF, BiasConv, C2fAttn, ConvBN, HGBlock, HGStem, RepConv, ResNetLayer

MIN_CHANNELS = 64  # the JAX int8 rule: narrower convs stay in the serving dtype


def folded_convs(model: nn.Module) -> List[nn.Module]:
    """The modules `fuse_conv_bn` folds, in module order: every RepConv and BiasConv, and every ConvBN that is not
    a branch of a RepConv (a RepConv runs its own fold, never its branches')."""
    branches = {id(c) for m in model.modules() if isinstance(m, RepConv) for c in (m.conv1, m.conv2)}
    return [m for m in model.modules()
            if isinstance(m, (RepConv, BiasConv)) or isinstance(m, ConvBN) and id(m) not in branches]


def conv3x3_sites(model: nn.Module) -> List[nn.Module]:
    """The modules that run a conv3x3 site once folded (3x3 stride 1 groups 1), in module order; in an int8
    serving copy not those that run through the s8 kernels."""
    return [m for m in folded_convs(model) if m.kernel_path and getattr(m, "q8", None) is None]


def site_eligible(conv: nn.Conv2d) -> bool:
    """The JAX `_site_eligible` (`lpc_yolo_tpu/nn/quant.py:90-97`) on a conv's logical shape: groups 1,
    undilated, min(Cin, Cout) >= 64."""
    return conv.groups == 1 and conv.dilation == (1, 1) and min(conv.in_channels, conv.out_channels) >= MIN_CHANNELS


class Int8Site(NamedTuple):
    """A site of a serving copy: its qualified name, its module (a ConvBN, or a folded RepConv), the conv that
    gives its geometry and the parts its input comes in (a quantize launch each)."""
    name: str
    module: nn.Module
    conv: nn.Conv2d
    parts: int


def int8_sites(model: nn.Module) -> List[Int8Site]:
    """The int8 sites of a serving graph, in module order: every ConvBN and RepConv that passes `site_eligible`,
    but for those of a head in the JAX `_HEADS` set (a Classify head's conv is a site, as in JAX), of v10Detect's
    one-to-many towers and of a dead layer (no forward runs them). A RepConv is one site, its folded 3x3; its
    branches are never sites (the JAX package serves them unfolded, two sites on one input: ROADMAP Queue 3).
    A site the kernel does not take (a kernel other than 1x1 or 3x3, a stride other than 1 or 2, padding other
    than k // 2) raises."""
    from .heads import Classify, V10Detect

    head = model.model[-1]
    unserved = [model.model[i] for i in model.dead]
    if isinstance(head, V10Detect):
        unserved += [head.cv2, head.cv3]
    elif not isinstance(head, Classify):
        unserved.append(head)
    skip = {id(m) for part in unserved for m in part.modules()}
    skip |= {id(c) for m in model.modules() if isinstance(m, RepConv) for c in (m.conv1, m.conv2)}
    parts = {}
    for m in model.modules():
        if isinstance(m, C2f):  # C2fCIB too: cv1's output (both halves) and each bottleneck's
            parts[id(m.cv2)] = 1 + len(m.m)
        elif isinstance(m, C2fAttn):  # as C2f, and the attention's output
            parts[id(m.cv2)] = 2 + len(m.m)
        elif isinstance(m, HGBlock):  # the input and each conv's output
            parts[id(m.sc)] = 1 + len(m.m)
        elif isinstance(m, SPPF):
            parts[id(m.cv2)] = 4
    sites = []
    for name, m in model.named_modules():
        if not isinstance(m, (ConvBN, RepConv)) or id(m) in skip:
            continue
        conv = m.conv1.conv if isinstance(m, RepConv) else m.conv
        if not site_eligible(conv):
            continue
        k, s = conv.kernel_size, conv.stride
        if k[0] != k[1] or s[0] != s[1] or conv.padding != (k[0] // 2, k[1] // 2):
            raise NotImplementedError(f"int8 site {name}: conv_s8 takes square same-padded kernels, not "
                                      f"{k} stride {s} padding {conv.padding}")
        check_geometry(k[0], s[0])
        sites.append(Int8Site(name, m, conv, parts.get(id(m), 1)))
    return sites


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
