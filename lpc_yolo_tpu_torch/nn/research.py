"""The research zoo's attention family, neck blocks and backbone families as torch nn.Modules (counterpart of
`lpc_yolo_tpu/nn/research.py`: the whole of it, :49-2003).

The 21 attention modules, the 15 neck blocks and the 23 backbone-family modules that the JAX YAML compiler reaches
through `build_research_module` (:2050-2068), with the helpers they use, in NCHW. Attribute and parameter names
mirror the JAX ones, numeric parts split off (`conv_0` -> `conv.0`), so the weight bridge stays a name map; a bare
JAX parameter (ECA's `conv`, ShuffleAttention's `cweight` ..., SpatialGroupEnhance's `weight` and `bias`,
CrissCrossAttention's `gamma`, MHSA's `rel_h` / `rel_w`, Swin's `relative_position_bias_table`, ConvNeXt's
`m_<i>_gamma`) is a Parameter of the same name and JAX layout. SKAttention's `fc` (channel -> d) is a Linear whose
children "0".."3" are the branch Linears `fc_0`..`fc_3`: torch keeps `fc.weight` beside `fc.0.weight` that way, with
no renamed key. NAMAttention's BatchNorm leaves sit at its root, so it is a `BatchNorm2d` itself.

Every conv+BN unit is a `CBA`, a `ConvBN` (`nn/modules.py`), so `nn/fuse.py` folds it for serving, a conv bias
included (`b' = beta + (b_conv - mean) * gamma / sigma`, which the JAX `fuse_conv_bn` drops), and a 3x3 s1 g1 one
runs the conv3x3 kernel: SKAttention's `conv_1` (ReLU) and ParNetAttention's `conv3x3` (no activation, a conv
bias); among the neck blocks GSBottleneck's `gs2.cv1`, BasicRFB's undilated 3x3s, PPA's `c1`..`c3`, ASFF's `conv`,
and the bare biased 3x3s of FGFP, FGFP_Head and the axial transformer (`BiasConv`, whose weight and bias keep the
JAX names); among the backbone families FasterNet's bias-free partial convs (a zero bias) and a 3x3 stride-1
mn_conv or Conv_BN_HSwish, whose hard-swish (like any activation that is no kernel epilogue: ReLU6, GELU, ELU)
runs after the kernel. A conv that a separate BatchNorm follows (InvertedBottleneck's biased `proj` and `bn`,
FasterNet's `proj` / `reduction` and `norm`) folds with it. Everything else runs in plain PyTorch, as the JAX package
left it to XLA: DySample's sampler is `F.grid_sample`, the axial and window attentions SDPA.

Divergences copied from the JAX package by design: flax's `nn.gelu` is the tanh form; SpatialGroupEnhance's
std is the biased one; CoTAttention's 9 * dim `attn2` channels are read k*k-major; the LayerNorms and the
GroupNorm take flax's eps 1e-6 (the neck blocks' and Swin's, ConvNeXt's and the patch embeddings' too); SeBlock
gates by a plain sigmoid; G_bneck reads no `k`, InvertedBottleneck no `sa`, and VanillaBlock's series activation has
no conv bias. Not copied: the JAX ShuffleAttention splits the map into blocks of rows where SA-Net (Zhang & Yang,
2021) splits the channels into groups; the JAX GSConv interleaves its two halves where the published slim-neck
forward takes the even channels, then the odd ones; the JAX DySample's initial offsets are transposed and its
sampler's border keeps the unclamped weights; the JAX StarBlock adds one residual around its n blocks where StarNet
adds one to each; the JAX SGBlock's "relu6" ConvBNs run no activation. The port runs the published forwards.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import apply_act
from .modules import (BN_EPS, BN_MOMENTUM, BatchNorm2d, BiasConv, ConvBN, GhostConv, autopad, folded_weight_bias,
                      folds_bn, store_folded)

LN_EPS = 1e-6  # flax LayerNorm's and GroupNorm's default epsilon
LPC_YAML = Path(__file__).resolve().parents[1] / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
LPC_ATTENTION_LAYER = 21  # LPC-YOLO's CBAM [7], on the 80² map at 64 channels at 640

# -- the parse rules of the research zoo (JAX research.py:2012-2047) ---------------------------------------------------
# the backbone families' YAML names
BACKBONE = {"G_bneck", "SGBlock", "DepthSepConv", "CBRM", "Shuffle_Block", "stem", "MBConvBlock", "Conv_BN_HSwish",
            "MobileNetV3_InvertedResidual", "mn_conv", "InvertedBottleneck", "MobileNetV3_BLOCK", "PatchEmbed",
            "PatchMerging", "SwinStage", "VanillaBlock", "ConvNeXt_Stem", "ConvNeXt_Downsample", "ConvNeXt_Block",
            "StarBlock", "BasicStage", "PatchEmbed_FasterNet", "PatchMerging_FasterNet"}
# args[0] a width-scaled output-channel count: out_args = [c1, c2, *rest]
WIDTH_SCALED = {"CoordAtt", "GAMAttention", "MSBlock", "C2f_MSBlock", "GSConv", "GSConvns", "VoVGSCSP", "VoVGSCSPC",
                "PPA", "BasicRFB"} | (BACKBONE - {"StarBlock", "BasicStage"})
# the width-scaled ones that take the depth-scaled repeat count at arg index 2 (after [c1, c2])
WIDTH_REPEAT = {"C2f_MSBlock", "VoVGSCSP", "ConvNeXt_Block"}
# the width-scaled ones whose args[3], an expansion width, scales too (JAX compiler.py:256-257)
WIDTH_SCALED_E = {"InvertedBottleneck", "MobileNetV3_BLOCK"}
# out_args = [c1, *yaml_args]; output channels unchanged (StarBlock: [c1, mlp_ratio, the repeats], JAX :265-267)
C1_PREPEND = {"SE", "ECA", "ShuffleAttention", "SKAttention", "DoubleAttention", "CoTAttention",
              "EffectiveSEModule", "GlobalContext", "GatherExcite", "MHSA", "AxialImageTransformer", "DySample",
              "SCSA", "FGFP", "FGFP_Head", "StarBlock", "BasicStage"}
# out_args = [c1] only
C1_ONLY = {"S2Attention", "NAMAttention", "CrissCrossAttention", "SequentialPolarizedSelfAttention",
           "ParallelPolarizedSelfAttention", "ParNetAttention"}
# args pass through untouched; output channels unchanged
PASSTHROUGH = {"SimAM", "SpatialGroupEnhance", "TripletAttention"}
# a list of maps in: out_args = [the levels' widths, the width-scaled c2, level]; the output is level's width
MULTI_INPUT = {"ASFF2", "ASFF3"}
NECK = {"BasicRFB", "MSBlock", "C2f_MSBlock", "GSConv", "GSConvns", "VoVGSCSP", "VoVGSCSPC", "PPA",
        "AxialImageTransformer", "DySample", "SCSA", "FGFP", "FGFP_Head"} | MULTI_INPUT
ATTENTION = (WIDTH_SCALED | C1_PREPEND | C1_ONLY | PASSTHROUGH) - NECK - BACKBONE
PORTED = ATTENTION | NECK | BACKBONE


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The zoo's activations by name (JAX :49-72); "gelu" is flax's tanh form."""
    if kind == "relu":
        return F.relu(x)
    if kind == "relu6":
        return x.clamp(0.0, 6.0)
    if kind in ("hswish", "hardswish"):
        return x * (x + 3.0).clamp(0.0, 6.0) / 6.0
    if kind in ("hsigmoid", "hard_sigmoid"):
        return (x + 3.0).clamp(0.0, 6.0) / 6.0
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu(x)
    if kind == "elu":
        return F.elu(x)
    if kind == "mish":
        return apply_act(x, "mish")
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind in ("none", "identity"):
        return x
    raise ValueError(f"unknown activation {kind!r}")


# the CBA activations that are a conv3x3 epilogue, by the kernel's names; the zoo's others follow the conv in PyTorch
_EPILOGUE = {"none": False, "identity": False, "relu": "relu", "silu": "silu", "mish": "mish"}
_POST_ACT = {"relu6", "hswish", "hardswish", "hsigmoid", "hard_sigmoid", "gelu", "elu", "sigmoid"}


class CBA(ConvBN):
    """Conv2d + optional BatchNorm + activation, the zoo's generic conv unit (JAX :75-118): a `ConvBN` with an
    optional conv bias and BN and the zoo's activation names ("silu" is SiLU here, never the YAML's default).
    Folded, its conv bias goes into the bias; without BN the fold is the conv itself, or the conv and the separate
    BatchNorm its owner names in `post_bn` (InvertedBottleneck's `proj` and `bn`). An activation that is no conv3x3
    epilogue (ReLU6, hard-swish, GELU, ELU, ...) runs after the conv in PyTorch (`post_act`): a 3x3 s1 g1 one is then
    a conv3x3 site with the `none` epilogue."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: str = "relu", bn: bool = True, bias: bool = False):
        super().__init__(c1, c2, k, s, p=p, g=g, d=d, act=False)
        if act not in _EPILOGUE and act not in _POST_ACT:
            raise ValueError(f"unknown activation {act!r}")
        if bias:
            self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=True)
        if not bn:
            self.bn = None
        self.act = _EPILOGUE.get(act, False)
        self.post_act = None if act in _EPILOGUE else act
        self.post_bn = ()  # (the BatchNorm after it,) where a BN-free CBA's owner has one: a tuple, so not a child

    @torch.no_grad()
    def fold(self, dtype: torch.dtype, in_scale: float = 1.0) -> None:
        if self.bn is not None:
            return super().fold(dtype, in_scale)
        if self.training:
            raise RuntimeError("CBA.fold() is for eval mode")
        w, b = folded_weight_bias(self.conv.weight, self.conv.bias, self.post_bn)
        self.folded = store_folded(w * in_scale, b, dtype, self.kernel_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded is None and self.bn is None:
            y = apply_act(self.conv(x), self.act)
        else:
            y = super().forward(x)
        return y if self.post_act is None else _act(y, self.post_act)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet's channel shuffle: out[j * groups + g] = in[g * (C / groups) + j] (JAX :121)."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _gap(x: torch.Tensor) -> torch.Tensor:
    return x.mean((2, 3), keepdim=True)


def _gmp(x: torch.Tensor) -> torch.Tensor:
    return x.amax((2, 3), keepdim=True)


def _pointwise(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    """A flax Dense over the channels of every position (NHWC `Dense(x)`): a 1x1 conv with the Linear's weight."""
    return F.conv2d(x, fc.weight[:, :, None, None], fc.bias)


# -- the squeeze-excite family ----------------------------------------------------------------------------------


class SE(nn.Module):
    """SENet with Linear layers (JAX :179): mean -> l1 -> ReLU -> l2 -> sigmoid gate."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        self.l1 = nn.Linear(c1, max(1, c1 // ratio), bias=False)
        self.l2 = nn.Linear(max(1, c1 // ratio), c1, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.l2(F.relu(self.l1(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class ECA(nn.Module):
    """Efficient channel attention (JAX :196): a 1-D conv of adaptive size k over the pooled channel vector;
    its kernel is the bare (k, 1, 1) parameter `conv` (k = 3 at 64 channels)."""

    def __init__(self, c1: int, gamma: int = 2, b: int = 1):
        super().__init__()
        k = int(abs((math.log(c1, 2) + b) / gamma))
        k = k if k % 2 else k + 1
        self.conv = nn.Parameter(torch.empty(k, 1, 1).uniform_(-math.sqrt(3.0 / k), math.sqrt(3.0 / k)))

    def forward(self, x):
        k = self.conv.shape[0]
        y = F.conv1d(x.mean((2, 3))[:, None], self.conv.reshape(1, 1, k).to(x.dtype), padding=k // 2)
        return x * torch.sigmoid(y[:, 0])[:, :, None, None]


class EffectiveSEModule(nn.Module):
    """VoVNet2's eSE (JAX :219): one 1x1 conv over the pooled features, a hard-sigmoid gate."""

    def __init__(self, c1: int, add_maxpool: bool = False):
        super().__init__()
        self.add_maxpool = add_maxpool
        self.fc = nn.Conv2d(c1, c1, 1)

    def forward(self, x):
        y = _gap(x)
        if self.add_maxpool:
            y = 0.5 * y + 0.5 * _gmp(x)
        return x * _act(self.fc(y), "hard_sigmoid")


class GatherExcite(nn.Module):
    """Gather-excite with a global extent and a parameter-free gather (JAX :547, extent 0)."""

    def __init__(self, channels: int, extent: int = 0, add_maxpool: bool = False, rd_ratio: float = 1.0 / 16):
        super().__init__()
        if extent != 0:
            raise NotImplementedError(f"GatherExcite with extent={extent} is not ported (extent 0 is)")
        rd = max(1, int(channels * rd_ratio))
        self.add_maxpool = add_maxpool
        self.mlp_fc1 = nn.Conv2d(channels, rd, 1)
        self.mlp_fc2 = nn.Conv2d(rd, channels, 1)

    def forward(self, x):
        ge = _gap(x)
        if self.add_maxpool:
            ge = 0.5 * ge + 0.5 * _gmp(x)
        return x * torch.sigmoid(self.mlp_fc2(F.relu(self.mlp_fc1(ge))))


class GlobalContext(nn.Module):
    """GCNet's global-context block (JAX :526): a softmax over the positions pools the context, then
    1x1 -> LayerNorm (eps 1e-6) -> ReLU -> 1x1 and a sigmoid gate."""

    def __init__(self, channels: int, rd_ratio: float = 1.0 / 8):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.conv_attn = nn.Conv2d(channels, 1, 1)
        self.mlp_fc1 = nn.Conv2d(channels, rd, 1)
        self.mlp_norm = nn.LayerNorm(rd, eps=LN_EPS)
        self.mlp_fc2 = nn.Conv2d(rd, channels, 1)

    def forward(self, x):
        attn = torch.softmax(self.conv_attn(x).flatten(2), -1)  # (B, 1, HW)
        context = torch.einsum("bcp,bkp->bc", x.flatten(2), attn)[:, :, None, None]
        y = self.mlp_fc1(context)
        y = F.relu(self.mlp_norm(y.flatten(1)))[:, :, None, None]
        return x * torch.sigmoid(self.mlp_fc2(y))


# -- the parameter-free or nearly free ones ---------------------------------------------------------------------


class SimAM(nn.Module):
    """Parameter-free SimAM (JAX :267)."""

    def __init__(self, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        n = x.shape[2] * x.shape[3] - 1
        d = (x - x.mean((2, 3), keepdim=True)) ** 2
        y = d / (4 * (d.sum((2, 3), keepdim=True) / n + self.e_lambda)) + 0.5
        return x * torch.sigmoid(y)


class SpatialGroupEnhance(nn.Module):
    """SGE (JAX :674): per group, the positions' similarity to the group's mean, normalised by its biased std
    (+1e-5), scaled and shifted by the bare (1, 1, 1, g) `weight` and `bias` (JAX layout), gates the group."""

    def __init__(self, groups: int = 8):
        super().__init__()
        if groups < 2:  # a (1, 1, 1, 1) weight would read as a 1x1 conv's kernel in the bridge
            raise NotImplementedError("SpatialGroupEnhance with groups < 2 is not ported")
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(1, 1, 1, groups))
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, groups))

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.groups
        xg = x.reshape(b, g, c // g, h, w)
        t = (xg * xg.mean((3, 4), keepdim=True)).sum(2).reshape(b, g, h * w)
        t = t - t.mean(-1, keepdim=True)
        t = t / (t.std(-1, correction=0, keepdim=True) + 1e-5)
        t = t.reshape(b, g, h, w) * self.weight.reshape(1, g, 1, 1) + self.bias.reshape(1, g, 1, 1)
        return (xg * torch.sigmoid(t)[:, :, None]).reshape(b, c, h, w)


class _ZPoolGate(nn.Module):
    """TripletAttention's gate (JAX :697): [max, mean] over dim 1 -> 7x7 CBA (no activation) -> sigmoid."""

    def __init__(self):
        super().__init__()
        self.conv = CBA(2, 1, 7, act="none")

    def forward(self, x):
        z = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.conv(z))


class TripletAttention(nn.Module):
    """Triplet attention (JAX :709). Each branch pools one axis and runs its 7x7 conv over the other two, the
    (row, column) plane of the JAX branch: `cw` pools H over (C, W), `hc` pools W over (H, C), `hw` pools C over
    (H, W)."""

    def __init__(self, no_spatial: bool = False):
        super().__init__()
        self.no_spatial = no_spatial
        self.cw, self.hc = _ZPoolGate(), _ZPoolGate()
        if not no_spatial:
            self.hw = _ZPoolGate()

    def forward(self, x):
        o1 = self.cw(x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)  # (B, H, C, W): pool H, plane (C, W)
        o2 = self.hc(x.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)  # (B, W, H, C): pool W, plane (H, C)
        if self.no_spatial:
            return (o1 + o2) / 2.0
        return (o1 + o2 + self.hw(x)) / 3.0


# -- the modules with BatchNorm of their own --------------------------------------------------------------------


class CoordAtt(nn.Module):
    """Coordinate attention (JAX :241): the map pooled along W and along H, both through one 1x1 + BN + hswish,
    then a sigmoid gate per row and per column."""

    def __init__(self, c1: int, c2: int, reduction: int = 32):
        super().__init__()
        mip = max(8, c1 // reduction)
        self.conv1 = nn.Conv2d(c1, mip, 1)
        self.bn1 = BatchNorm2d(mip, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.conv_h = nn.Conv2d(mip, c2, 1)
        self.conv_w = nn.Conv2d(mip, c2, 1)

    def forward(self, x):
        h = x.shape[2]
        y = torch.cat([x.mean(3), x.mean(2)], 2)[..., None]  # (B, C, H + W, 1)
        y = _act(self.bn1(self.conv1(y)), "hswish")
        a_h = torch.sigmoid(self.conv_h(y[:, :, :h]))  # (B, c2, H, 1)
        a_w = torch.sigmoid(self.conv_w(y[:, :, h:]))  # (B, c2, W, 1)
        return x * a_w.transpose(2, 3) * a_h


class NAMAttention(BatchNorm2d):
    """Normalization-based attention (JAX :343): a BatchNorm (eps 1e-3, momentum 0.03, the JAX running
    statistics) whose |gamma| / sum |gamma| weighs the channels of a sigmoid gate. Its leaves sit at the module's
    root, as in the JAX tree, and its gamma is the saliency as well, so it never folds."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        y = super().forward(x)
        w = self.weight.abs() / self.weight.abs().sum()
        return torch.sigmoid(y * w[:, None, None]) * x


class GAMAttention(nn.Module):
    """Global attention mechanism (JAX :401): a per-position channel MLP, then two grouped 7x7 CBAs (g = rate),
    a sigmoid and a 4-group channel shuffle gate the map."""

    def __init__(self, c1: int, c2: int, group: bool = True, rate: int = 4):
        super().__init__()
        g = rate if group else 1
        self.ca_fc1 = nn.Linear(c1, max(1, c1 // rate))
        self.ca_fc2 = nn.Linear(max(1, c1 // rate), c1)
        self.sa1 = CBA(c1, c1 // rate, 7, g=g, act="relu")
        self.sa2 = CBA(c1 // rate, c2, 7, g=g, act="none")

    def forward(self, x):
        x = x * _pointwise(F.relu(_pointwise(x, self.ca_fc1)), self.ca_fc2)
        s = channel_shuffle(torch.sigmoid(self.sa2(self.sa1(x))), 4)
        return x * s


# -- the modules with conv3x3 sites -----------------------------------------------------------------------------


class _LinearWithBranches(nn.Linear):
    """SKAttention's `fc` (channel -> d), holding the branch Linears `fc_i` (d -> channel) as its children "i"."""

    def __init__(self, c: int, d: int, n: int):
        super().__init__(c, d)
        for i in range(n):
            self.add_module(str(i), nn.Linear(d, c))

    def branch(self, i: int) -> nn.Linear:
        return self._modules[str(i)]


class SKAttention(nn.Module):
    """Selective-kernel attention (JAX :427): a ReLU CBA per kernel size (1, 3, 5, 7), summed and pooled into
    `fc`, whose branch Linears' softmax over the kernels mixes the branches. `conv.1` is a conv3x3 site."""

    def __init__(self, channel: int, kernels: Sequence[int] = (1, 3, 5, 7), reduction: int = 16, group: int = 1,
                 L: int = 32):
        super().__init__()
        d = max(L, channel // reduction)
        self.conv = nn.ModuleList(CBA(channel, channel, k, g=group, act="relu") for k in kernels)
        self.fc = _LinearWithBranches(channel, d, len(kernels))

    def forward(self, x):
        feats = [conv(x) for conv in self.conv]
        u = sum(feats)
        z = self.fc(u.mean((2, 3)))
        attn = torch.softmax(torch.stack([self.fc.branch(i)(z) for i in range(len(feats))]), 0)
        return (attn[:, :, :, None, None] * torch.stack(feats)).sum(0)


class ParNetAttention(nn.Module):
    """ParNet's parallel attention (JAX :605): SiLU(1x1 CBA + 3x3 CBA + x * SSE gate), both CBAs with a conv
    bias and no activation; `conv3x3` is a conv3x3 site with the `none` epilogue once folded."""

    def __init__(self, channel: int):
        super().__init__()
        self.sse_fc = nn.Conv2d(channel, channel, 1)
        self.conv1x1 = CBA(channel, channel, 1, act="none", bias=True)
        self.conv3x3 = CBA(channel, channel, 3, act="none", bias=True)

    def forward(self, x):
        sse = torch.sigmoid(self.sse_fc(_gap(x)))
        return F.silu(self.conv1x1(x) + self.conv3x3(x) + x * sse)


class CoTAttention(nn.Module):
    """Contextual transformer attention (JAX :504). `key_embed` is a grouped (g = 4) 3x3 CBA, not a conv3x3 site;
    `attn2`'s k*k*dim channels are averaged over the k*k taps read k*k-major, as the JAX NHWC reshape reads them."""

    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.kk = kernel_size * kernel_size
        self.key_embed = CBA(dim, dim, kernel_size, g=4, act="relu")
        self.value_embed = CBA(dim, dim, 1, act="none")
        self.attn1 = CBA(2 * dim, 2 * dim // 4, 1, act="relu")
        self.attn2 = nn.Conv2d(2 * dim // 4, self.kk * dim, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        k1 = self.key_embed(x)
        v = self.value_embed(x)
        att = self.attn2(self.attn1(torch.cat([k1, x], 1))).reshape(b, self.kk, c, h, w).mean(1)
        k2 = torch.softmax(att.reshape(b, c, h * w), -1) * v.reshape(b, c, h * w)
        return k1 + k2.reshape(b, c, h, w)


# -- the token-mixing modules -----------------------------------------------------------------------------------


class ShuffleAttention(nn.Module):
    """SA-Net's shuffle attention, the published forward: the channels in G groups, each split in halves, one
    gated by its pooled mean (`cweight`, `cbias`), one by its GroupNorm (`sweight`, `sbias`; eps 1e-6 as flax's),
    then a 2-group channel shuffle. The bare parameters keep the JAX layout (1, 1, 1, C / 2G). The JAX module
    (:455) reshapes the NHWC map to (B * G, H, W, C / G), which splits it into blocks of rows instead."""

    def __init__(self, channel: int, G: int = 8):
        super().__init__()
        self.G = G
        cg = channel // (2 * G)
        self.cweight = nn.Parameter(torch.zeros(1, 1, 1, cg))
        self.cbias = nn.Parameter(torch.ones(1, 1, 1, cg))
        self.sweight = nn.Parameter(torch.zeros(1, 1, 1, cg))
        self.sbias = nn.Parameter(torch.ones(1, 1, 1, cg))
        self.gn = nn.GroupNorm(cg, cg, eps=LN_EPS)

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.reshape(b * self.G, c // self.G, h, w)
        x0, x1 = x.chunk(2, 1)
        cw, cb, sw, sb = (p.reshape(1, -1, 1, 1) for p in (self.cweight, self.cbias, self.sweight, self.sbias))
        xc = x0 * torch.sigmoid(cw * _gap(x0) + cb)
        xs = x1 * torch.sigmoid(sw * self.gn(x1) + sb)
        return channel_shuffle(torch.cat([xc, xs], 1).reshape(b, c, h, w), 2)


class DoubleAttention(nn.Module):
    """A2-Net's double attention (JAX :480): gather descriptors by a softmax over convB's channels, distribute
    them by a softmax over convV's, then a 1x1 reconstruction."""

    def __init__(self, c1: int, reconstruct: bool = True):
        super().__init__()
        self.cm = self.cn = int(c1 * 0.25)
        self.convA = nn.Conv2d(c1, self.cm, 1)
        self.convB = nn.Conv2d(c1, self.cn, 1)
        self.convV = nn.Conv2d(c1, self.cn, 1)
        self.conv_reconstruct = nn.Conv2d(self.cm, c1, 1) if reconstruct else None

    def forward(self, x):
        b, _, h, w = x.shape
        A = self.convA(x).flatten(2)  # (B, cm, HW)
        attn_maps = torch.softmax(self.convB(x).flatten(2), 1)
        attn_vecs = torch.softmax(self.convV(x).flatten(2), 1)
        gd = torch.einsum("bcp,bnp->bcn", A, attn_maps)
        z = torch.einsum("bcn,bnp->bcp", gd, attn_vecs).reshape(b, self.cm, h, w)
        return z if self.conv_reconstruct is None else self.conv_reconstruct(z)


def _shift(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """x shifted by one along `dim` (step 1: towards higher indices), the edge row or column repeated."""
    n = x.shape[dim]
    if step > 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _spatial_shift1(x: torch.Tensor) -> torch.Tensor:
    """S2-MLPv2's first shift (JAX :303): the channel quarters shifted down, up, right, left."""
    q = x.shape[1] // 4
    a, b, c, d = x[:, :q], x[:, q:2 * q], x[:, 2 * q:3 * q], x[:, 3 * q:]
    return torch.cat([_shift(a, 2, 1), _shift(b, 2, -1), _shift(c, 3, 1), _shift(d, 3, -1)], 1)


def _spatial_shift2(x: torch.Tensor) -> torch.Tensor:
    """The second shift (JAX :312): right, left, down, up."""
    q = x.shape[1] // 4
    a, b, c, d = x[:, :q], x[:, q:2 * q], x[:, 2 * q:3 * q], x[:, 3 * q:]
    return torch.cat([_shift(a, 3, 1), _shift(b, 3, -1), _shift(c, 2, 1), _shift(d, 2, -1)], 1)


class SplitAttention(nn.Module):
    """S2-MLPv2's split attention over k branches (JAX :281), on (B, k, C, H, W)."""

    def __init__(self, channel: int = 512, k: int = 3):
        super().__init__()
        self.k = k
        self.mlp1 = nn.Linear(channel, channel, bias=False)
        self.mlp2 = nn.Linear(channel, channel * k, bias=False)

    def forward(self, x_all):
        b, k, c = x_all.shape[:3]
        a = x_all.sum(1).sum((2, 3))
        hat_a = self.mlp2(F.gelu(self.mlp1(a), approximate="tanh")).reshape(b, k, c)
        return (torch.softmax(hat_a, 1)[..., None, None] * x_all).sum(1)


class S2Attention(nn.Module):
    """S2-MLPv2 attention (JAX :322): a per-position MLP to 3C, two spatial shifts of two thirds, split attention
    over the three, a per-position MLP back."""

    def __init__(self, channels: int = 512):
        super().__init__()
        self.c = channels
        self.mlp1 = nn.Linear(channels, channels * 3)
        self.split_attention = SplitAttention(channels, 3)
        self.mlp2 = nn.Linear(channels, channels)

    def forward(self, x):
        c = self.c
        y = _pointwise(x, self.mlp1)
        x_all = torch.stack([_spatial_shift1(y[:, :c]), _spatial_shift2(y[:, c:2 * c]), y[:, 2 * c:]], 1)
        return _pointwise(self.split_attention(x_all), self.mlp2)


class CrissCrossAttention(nn.Module):
    """Criss-cross attention (JAX :371): each position attends over its column (itself excluded: -inf on the H
    path's diagonal) and its row in one softmax; `gamma` scales the result, added to the input."""

    def __init__(self, c1: int):
        super().__init__()
        cq = max(1, c1 // 8)
        self.query_conv = nn.Conv2d(c1, cq, 1)
        self.key_conv = nn.Conv2d(c1, cq, 1)
        self.value_conv = nn.Conv2d(c1, c1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        h = x.shape[2]
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        energy_h = torch.einsum("bchw,bckw->bhwk", q, k)  # (B, H, W, H)
        eye = torch.eye(h, dtype=torch.bool, device=x.device)[:, None, :]
        energy_h = energy_h.masked_fill(eye, float("-inf"))
        energy_w = torch.einsum("bchw,bchk->bhwk", q, k)  # (B, H, W, W)
        att = torch.softmax(torch.cat([energy_h, energy_w], 3), 3)
        out_h = torch.einsum("bckw,bhwk->bchw", v, att[..., :h])
        out_w = torch.einsum("bchk,bhwk->bchw", v, att[..., h:])
        return self.gamma * (out_h + out_w) + x


class MHSA(nn.Module):
    """BoTNet's multi-head self-attention over all positions (JAX :576), with no 1/sqrt(d) scale: SDPA with
    scale 1, its heads the channels' consecutive blocks of C / heads. With `pos_emb` the content-position logits
    of `rel_h` + `rel_w` (the first H * W of the height * width table, as the JAX module slices it) are added."""

    def __init__(self, n_dims: int, width: int = 14, height: int = 14, heads: int = 4, pos_emb: bool = False):
        super().__init__()
        self.heads, self.pos_emb = heads, pos_emb
        self.query = nn.Conv2d(n_dims, n_dims, 1)
        self.key = nn.Conv2d(n_dims, n_dims, 1)
        self.value = nn.Conv2d(n_dims, n_dims, 1)
        if pos_emb:
            hd = n_dims // heads
            self.rel_h = nn.Parameter(torch.randn(1, heads, hd, 1, height))
            self.rel_w = nn.Parameter(torch.randn(1, heads, hd, width, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        hd = c // self.heads

        def split(t):  # (B, C, H, W) -> (B, heads, HW, hd)
            return t.reshape(b, self.heads, hd, h * w).transpose(2, 3)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        bias = None
        if self.pos_emb:
            pos = (self.rel_h + self.rel_w).reshape(1, self.heads, hd, -1)[..., :h * w].to(x.dtype)
            bias = torch.einsum("nhdk,bhqd->bhqk", pos, q)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=1.0)
        return out.transpose(2, 3).reshape(b, c, h, w)


class _PolarizedChannel(nn.Module):
    """Polarized self-attention's channel branch (JAX :619)."""

    def __init__(self, channel: int):
        super().__init__()
        self.ch_wv = nn.Conv2d(channel, channel // 2, 1)
        self.ch_wq = nn.Conv2d(channel, 1, 1)
        self.ch_wz = nn.Conv2d(channel // 2, channel, 1)
        self.ln = nn.LayerNorm(channel, eps=LN_EPS)

    def forward(self, x):
        wv = self.ch_wv(x).flatten(2)  # (B, C/2, HW)
        wq = torch.softmax(self.ch_wq(x).flatten(2), -1)  # (B, 1, HW)
        wz = torch.einsum("bcp,bkp->bc", wv, wq)[:, :, None, None]
        weight = self.ch_wz(wz)
        return x * torch.sigmoid(self.ln(weight.flatten(1)))[:, :, None, None]


class _PolarizedSpatial(nn.Module):
    """Polarized self-attention's spatial branch (JAX :635)."""

    def __init__(self, channel: int):
        super().__init__()
        self.sp_wv = nn.Conv2d(channel, channel // 2, 1)
        self.sp_wq = nn.Conv2d(channel, channel // 2, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        wv = self.sp_wv(x).flatten(2)  # (B, C/2, HW)
        wq = torch.softmax(self.sp_wq(x).mean((2, 3)), -1)  # (B, C/2)
        wz = torch.einsum("bc,bcp->bp", wq, wv).reshape(b, 1, h, w)
        return x * torch.sigmoid(wz)


class ParallelPolarizedSelfAttention(nn.Module):
    """Polarized self-attention, the branches side by side (JAX :649)."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel = _PolarizedChannel(channel)
        self.spatial = _PolarizedSpatial(channel)

    def forward(self, x):
        return self.channel(x) + self.spatial(x)


class SequentialPolarizedSelfAttention(ParallelPolarizedSelfAttention):
    """Polarized self-attention, the spatial branch after the channel branch (JAX :662)."""

    def forward(self, x):
        return self.spatial(self.channel(x))


# -- the neck blocks' helpers (JAX :137-160) -----------------------------------------------------------------------


def max_pool(x: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    """flax's max pool over a map padded with -inf (JAX :137)."""
    return F.max_pool2d(F.pad(x, (p, p, p, p), value=float("-inf")) if p else x, k, s)


def avg_pool(x: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    """flax's average pool over a map padded with zeros, which count in the mean (JAX :143)."""
    return F.avg_pool2d(F.pad(x, (p, p, p, p)) if p else x, k, s)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` (JAX :149): the source pixel under each output pixel's centre."""
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` when upsampling (JAX :153): half-pixel, edges clamped."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


# -- the slim-neck family (GSConv, VoV-GSCSP; JAX :1420-1534) ----------------------------------------------------


def gsconv_shuffle(y: torch.Tensor) -> torch.Tensor:
    """The published slim-neck `GSConv.forward`'s shuffle of [x1, cv2(x1)]: the even channels, then the odd ones.
    The JAX module (:1439-1441) interleaves the two halves instead; the two agree at 4 channels."""
    return torch.cat([y[:, 0::2], y[:, 1::2]], 1)


class GSConv(nn.Module):
    """GSConv (JAX :1420): a k x k stride-s ConvBN to c2 / 2, a 5x5 depthwise ConvBN of it, both Mish (none with
    act False), concatenated and shuffled by `gsconv_shuffle`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        c_, a = c2 // 2, "mish" if act else False
        self.cv1 = ConvBN(c1, c_, k, s, g=g, act=a)
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act=a)

    def forward(self, x):
        x1 = self.cv1(x)
        return gsconv_shuffle(torch.cat([x1, self.cv2(x1)], 1))


class GSConvns(nn.Module):
    """GSConv with the learned shuffle (JAX :1444): a 1x1 and a 5x5 depthwise ConvBN (Mish), then `shuf`, a
    bias-free 1x1 over both halves, and a ReLU. `k` and `s` are taken and ignored, as in the JAX module and the
    published one."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act="mish")
        self.shuf = nn.Conv2d(c2, c2, 1, bias=False)

    def forward(self, x):
        x1 = self.cv1(x)
        return F.relu(self.shuf(torch.cat([x1, self.cv2(x1)], 1)))


class GSBottleneck(nn.Module):
    """GS bottleneck (JAX :1462): GSConv 1x1, GSConv 3x3 without activation (its `gs2.cv1` a conv3x3 site with the
    `none` epilogue), plus a 1x1 ConvBN shortcut."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.gs1 = GSConv(c1, c_, 1, 1)
        self.gs2 = GSConv(c_, c2, 3, 1, act=False)
        self.shortcut = ConvBN(c1, c2, 1, 1, act=False)

    def forward(self, x):
        return self.gs2(self.gs1(x)) + self.shortcut(x)


class GSBottleneckC(nn.Module):
    """The cheap GS bottleneck (JAX :1481): its shortcut a gcd(c1, c2)-grouped k x k stride-s ConvBN."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = int(c2 * 0.5)
        self.gs1 = GSConv(c1, c_, 1, 1)
        self.gs2 = GSConv(c_, c2, 3, 1, act=False)
        self.shortcut = ConvBN(c1, c2, k, s, g=math.gcd(c1, c2), act=False)

    def forward(self, x):
        return self.gs2(self.gs1(x)) + self.shortcut(x)


class VoVGSCSP(nn.Module):
    """VoV-GSCSP (JAX :1498): cv1 1x1 to c2 / 2 through n GSBottlenecks (`gsb.<i>`), beside cv2 1x1 of the input,
    concatenated [cv2, gsb] into cv3 1x1, all Mish; the compiler passes the depth-scaled n."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1, act="mish")
        self.gsb = nn.ModuleList(GSBottleneck(c_, c_, e=1.0) for _ in range(n))
        self.cv2 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv3 = ConvBN(2 * c_, c2, 1, act="mish")

    def bottlenecks(self, x):
        for m in self.gsb:
            x = m(x)
        return x

    def forward(self, x):
        return self.cv3(torch.cat([self.cv2(x), self.bottlenecks(self.cv1(x))], 1))


class VoVGSCSPC(VoVGSCSP):
    """The cheap VoV-GSCSP (JAX :1527): one GSBottleneckC (`gsb`) with a depthwise 1x1 shortcut; a YAML repeat
    stacks the whole block instead."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, e)
        c_ = int(c2 * e)
        self.gsb = GSBottleneckC(c_, c_, 1, 1)

    def bottlenecks(self, x):
        return self.gsb(x)


# -- the receptive-field block (JAX :734) -------------------------------------------------------------------------


class BasicRFB(nn.Module):
    """RFB (JAX :734): three branches of 1x1 -> 3x3 (ReLU) [-> 3x3 (ReLU)] -> a 3x3 dilated by vision + 1, 2, 4
    (no activation), concatenated into `conv_linear`, scaled by `scale`, plus the 1x1 `shortcut`, then a ReLU.
    The undilated stride-1 3x3s (`b0.1`, `b1.1`, `b2.1`, `b2.2` at stride 1) are conv3x3 sites; the dilated ones
    run through F.conv2d."""

    def __init__(self, c1: int, c2: int, stride: int = 1, scale: float = 0.1, map_reduce: int = 8, vision: int = 1,
                 groups: int = 1):
        super().__init__()
        i, g, v, s = c1 // map_reduce, groups, vision, stride
        self.scale = scale
        self.b0 = nn.Sequential(CBA(c1, i, 1, g=g, act="none"), CBA(i, 2 * i, 3, s=s, g=g),
                                CBA(2 * i, 2 * i, 3, p=v + 1, d=v + 1, g=g, act="none"))
        self.b1 = nn.Sequential(CBA(c1, i, 1, g=g, act="none"), CBA(i, 2 * i, 3, s=s, g=g),
                                CBA(2 * i, 2 * i, 3, p=v + 2, d=v + 2, g=g, act="none"))
        self.b2 = nn.Sequential(CBA(c1, i, 1, g=g, act="none"), CBA(i, (i // 2) * 3, 3, g=g),
                                CBA((i // 2) * 3, 2 * i, 3, s=s, g=g),
                                CBA(2 * i, 2 * i, 3, p=v + 4, d=v + 4, g=g, act="none"))
        self.conv_linear = CBA(6 * i, c2, 1, act="none")
        self.shortcut = CBA(c1, c2, 1, s=s, act="none")

    def forward(self, x):
        out = self.conv_linear(torch.cat([self.b0(x), self.b1(x), self.b2(x)], 1))
        return F.relu(out * self.scale + self.shortcut(x))


# -- YOLO-MS's multi-scale block (JAX :1537-1594) -----------------------------------------------------------------


class MSBlock(nn.Module):
    """MSBlock (JAX :1537): `in_conv` 1x1 to c1 * in_expand_ratio / in_down_ratio, split in one part a kernel
    size; past the first, each part adds the previous part's output, and a part of kernel k > 1 runs `layers_num`
    times 1x1 -> k x k depthwise -> 1x1 (`mid.<i>.<j>_in` / `_mid` / `_out`, all SiLU); the parts concatenated into
    `out_conv`. The depthwise convs are not conv3x3 sites."""

    def __init__(self, c1: int, c2: int, kernel_sizes: Sequence[int] = (1, 3, 3), in_expand_ratio: float = 3.0,
                 mid_expand_ratio: float = 2.0, layers_num: int = 3, in_down_ratio: float = 1.0):
        super().__init__()
        in_ch = int(c1 * in_expand_ratio // in_down_ratio)
        self.mid_ch = mid = in_ch // len(kernel_sizes)
        groups = int(mid * mid_expand_ratio)
        self.kernel_sizes = tuple(kernel_sizes)
        self.in_conv = ConvBN(c1, in_ch, 1, act="silu")
        self.mid = nn.ModuleDict()
        for i, k in enumerate(self.kernel_sizes):
            if k == 1:
                continue
            self.mid[str(i)] = nn.ModuleDict()
            for j in range(int(layers_num)):
                self.mid[str(i)][f"{j}_in"] = ConvBN(mid, groups, 1, act="silu")
                self.mid[str(i)][f"{j}_mid"] = ConvBN(groups, groups, k, g=groups, act="silu")
                self.mid[str(i)][f"{j}_out"] = ConvBN(groups, mid, 1, act="silu")
        self.layers_num = int(layers_num)
        self.out_conv = ConvBN(mid * len(self.kernel_sizes), c2, 1, act="silu")

    def forward(self, x):
        out, mid, parts = self.in_conv(x), self.mid_ch, []
        for i, k in enumerate(self.kernel_sizes):
            ch = out[:, i * mid:(i + 1) * mid]
            if i >= 1:
                ch = ch + parts[i - 1]
            if k != 1:
                m = self.mid[str(i)]
                for j in range(self.layers_num):
                    ch = m[f"{j}_out"](m[f"{j}_mid"](m[f"{j}_in"](ch)))
            parts.append(ch)
        return self.out_conv(torch.cat(parts, 1))


class C2f_MSBlock(nn.Module):
    """C2f with MSBlocks (JAX :1578): cv1 1x1 to 2c (SiLU), n MSBlocks on the last half, all concatenated into cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        self.c = c
        self.cv1 = ConvBN(c1, 2 * c, 1, 1, act="silu")
        self.m = nn.ModuleList(MSBlock(c, c) for _ in range(n))
        self.cv2 = ConvBN((2 + n) * c, c2, 1, act="silu")

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


# -- adaptive spatial feature fusion (JAX :1597-1670) -------------------------------------------------------------


class _UpsampleT(nn.Module):
    """ASFF's s x upsample (JAX :1597): an s x s stride-s transposed conv with a bias. Its flax kernel (kh, kw, in,
    out), applied by `lax.conv_transpose` unflipped, is the torch weight (in, out, kh, kw) flipped in both spatial
    axes; the bridge flips it (`utils/flax_bridge.py`)."""

    def __init__(self, c1: int, c2: int, scale: int = 2):
        super().__init__()
        self.cv1 = nn.ConvTranspose2d(c1, c2, scale, scale, bias=True)

    def forward(self, x):
        return self.cv1(x)


class _ASFF(nn.Module):
    """Adaptive spatial feature fusion over the levels in `c1` (JAX ASFF2 :1611, ASFF3 :1640), at the resolution and
    width of `level`: finer levels come down by s x s stride-s ConvBNs (`down<j>`), coarser ones up by `_UpsampleT`
    (`up<j>`), each to 8 channels (`w<j>`, SiLU) for a biased 1x1 (`weights_levels`) whose softmax over the levels
    mixes them; `conv` (3x3 SiLU, a conv3x3 site) finishes. The forward takes the list of the levels' maps."""

    def __init__(self, c1: Sequence[int], c2: int, level: int = 0):
        super().__init__()
        self.level = level
        inter = c1[level]
        n = len(c1)
        for j in range(n):
            if j < level:  # a finer level: 2x2 s2 one level below, 4x4 s4 two below
                self.add_module(f"down{j}", ConvBN(c1[j], inter, 2 ** (level - j), 2 ** (level - j), p=0, act="silu"))
            elif j > level:
                self.add_module(f"up{j}", _UpsampleT(c1[j], inter, 2 ** (j - level)))
        for j in range(n):
            self.add_module(f"w{j}", ConvBN(inter, 8, 1, act="silu"))
        self.weights_levels = nn.Conv2d(8 * n, n, 1)
        self.conv = ConvBN(inter, inter, 3, 1, act="silu")

    def forward(self, xs):
        r = [x if j == self.level else getattr(self, f"down{j}" if j < self.level else f"up{j}")(x)
             for j, x in enumerate(xs)]
        w = torch.softmax(self.weights_levels(torch.cat([getattr(self, f"w{j}")(t) for j, t in enumerate(r)], 1)), 1)
        return self.conv(sum(t * w[:, j:j + 1] for j, t in enumerate(r)))


class ASFF2(_ASFF):
    """ASFF over two levels (JAX :1611); `c1` the (finer, coarser) widths."""

    def __init__(self, c1: Sequence[int], c2: int, level: int = 0):
        if len(c1) != 2:
            raise ValueError(f"ASFF2 fuses two levels, got widths {tuple(c1)}")
        super().__init__(c1, c2, level)


class ASFF3(_ASFF):
    """ASFF over three levels (JAX :1640)."""

    def __init__(self, c1: Sequence[int], c2: int, level: int = 0):
        if len(c1) != 3:
            raise ValueError(f"ASFF3 fuses three levels, got widths {tuple(c1)}")
        super().__init__(c1, c2, level)


# -- DySample (JAX :1701) -----------------------------------------------------------------------------------------


def dysample_init_pos(scale: int, groups: int) -> torch.Tensor:
    """The published DySample's initial offsets, (2 * groups * scale², ) in the offset conv's channel order
    (coordinate, group, subpixel row, subpixel column): x follows the subpixel's column, y its row, so that at zero
    offset the sampler is the half-pixel bilinear upsample. The JAX module (:1718-1722) swaps the two."""
    h = (torch.arange(scale, dtype=torch.float32) - (scale - 1) / 2) / scale
    x_off, y_off = h[None, :].expand(scale, scale), h[:, None].expand(scale, scale)
    return torch.stack([x_off, y_off]).reshape(2, 1, scale * scale).expand(2, groups, scale * scale).reshape(-1)


def dysample_grid(offset: torch.Tensor, scale: int) -> torch.Tensor:
    """The published sampler's grid from the offsets (B, 2 * G, H, W), G = groups * scale²: the pixel centres
    plus the offsets, normalised to [-1, 1], pixel-shuffled into (B * groups, sH, sW, 2) (x, y)."""
    b, _, h, w = offset.shape
    off = offset.view(b, 2, -1, h, w)
    base = torch.stack(torch.meshgrid(torch.arange(w, device=offset.device, dtype=offset.dtype) + 0.5,
                                      torch.arange(h, device=offset.device, dtype=offset.dtype) + 0.5,
                                      indexing="xy"))  # (2, H, W): x, y
    norm = torch.tensor([w, h], device=offset.device, dtype=offset.dtype).view(1, 2, 1, 1, 1)
    coords = 2 * (base[None, :, None] + off) / norm - 1
    coords = F.pixel_shuffle(coords.reshape(b, -1, h, w), scale)
    return coords.view(b, 2, -1, scale * h, scale * w).permute(0, 2, 3, 4, 1).flatten(0, 1)


class DySample(nn.Module):
    """DySample, the published "lp" style (Liu et al., 2023; JAX :1701): a biased 1x1 `offset` conv to
    2 * groups * scale² channels (its output in the published (2, groups * scale²) order: the bridge permutes the
    JAX (groups, scale², 2) order into it), times 0.25 plus `dysample_init_pos`, samples each channel group with
    `F.grid_sample` (bilinear, border, align_corners=False) on `dysample_grid`. The offsets and the sampling run in
    f32 (bf16 coordinates would be off by a third of a pixel at 80 columns). Another `style` raises, where the JAX
    module runs "lp" whatever it is given."""

    def __init__(self, c1: int, scale: int = 2, style: str = "lp", groups: int = 4):
        super().__init__()
        if style != "lp":
            raise NotImplementedError(f"DySample style {style!r} is not ported (the JAX module runs 'lp' for any)")
        self.scale, self.groups = scale, groups
        self.offset = nn.Conv2d(c1, 2 * groups * scale * scale, 1)
        self.register_buffer("init_pos", dysample_init_pos(scale, groups), persistent=False)

    def forward(self, x):
        b, c, h, w = x.shape
        offset = self.offset(x).float() * 0.25 + self.init_pos.float().view(1, -1, 1, 1)
        grid = dysample_grid(offset, self.scale)
        out = F.grid_sample(x.float().reshape(b * self.groups, -1, h, w), grid, mode="bilinear",
                            padding_mode="border", align_corners=False)
        return out.view(b, c, self.scale * h, self.scale * w).to(x.dtype)


# -- HCF-Net's PPA, SCSA, FGFP (JAX :1744-1945) -------------------------------------------------------------------


class _SpatialAttnModule(nn.Module):
    """PPA's spatial gate (JAX :1744): [mean, max] over the channels -> a biased 7x7 `conv2d` -> sigmoid."""

    def __init__(self):
        super().__init__()
        self.conv2d = nn.Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        z = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv2d(z)) * x


class LocalGlobalAttention(nn.Module):
    """HCF-Net's local-global attention over p x p patches (JAX :1757): each patch's channel-mean pixels through
    `mlp1` (Linear), a LayerNorm (eps 1e-6), `mlp2`, gated by their softmax and by their cosine with `prompt`
    (clipped to [0, 1]), times `top_down_transform`, resized bilinearly back to the map and a biased 1x1 `conv`."""

    def __init__(self, output_dim: int, patch_size: int):
        super().__init__()
        p, d = patch_size, output_dim
        self.p = p
        self.mlp1 = nn.Linear(p * p, d // 2)
        self.norm = nn.LayerNorm(d // 2, eps=LN_EPS)
        self.mlp2 = nn.Linear(d // 2, d)
        self.prompt = nn.Parameter(torch.randn(d))
        self.top_down_transform = nn.Parameter(torch.eye(d))
        self.conv = nn.Conv2d(d, d, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        p = self.p
        hp, wp = h // p, w // p
        pix = x.mean(1)[:, :hp * p, :wp * p].reshape(b, hp, p, wp, p).permute(0, 1, 3, 2, 4).reshape(b, hp * wp, p * p)
        feats = self.mlp2(self.norm(self.mlp1(pix)))
        local = feats * torch.softmax(feats, -1)
        prompt = self.prompt.to(x.dtype)
        cos = (local / (local.norm(dim=-1, keepdim=True) + 1e-6)) @ (prompt / (prompt.norm() + 1e-6))
        local = (local * cos.clamp(0, 1)[..., None]) @ self.top_down_transform.to(x.dtype)
        local = local.transpose(1, 2).reshape(b, -1, hp, wp)
        return self.conv(resize_bilinear(local, h, w))


class PPA(nn.Module):
    """HCF-Net's parallelized patch-aware attention (JAX :1785): a biased 1x1 CBA `skip` (BN, no activation), its
    local-global attentions over 2x2 and 4x4 patches, three chained 3x3 CBAs with a conv bias and ReLU (`c1`,
    `c2`, `c3`: conv3x3 sites, the conv bias folded), all summed, then ECA (`cn`), the spatial gate (`sa`), a
    BatchNorm (`bn1`) and a ReLU."""

    def __init__(self, c1: int, filters: int):
        super().__init__()
        f = filters
        self.skip = CBA(c1, f, 1, p=0, act="none", bias=True)
        self.lga2 = LocalGlobalAttention(f, 2)
        self.lga4 = LocalGlobalAttention(f, 4)
        self.c1 = CBA(c1, f, 3, act="relu", bias=True)
        self.c2 = CBA(f, f, 3, act="relu", bias=True)
        self.c3 = CBA(f, f, 3, act="relu", bias=True)
        self.cn = ECA(f)
        self.sa = _SpatialAttnModule()
        self.bn1 = BatchNorm2d(f, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        skip = self.skip(x)
        x1 = self.c1(x)
        x2 = self.c2(x1)
        x3 = self.c3(x2)
        y = x1 + x2 + x3 + skip + self.lga2(skip) + self.lga4(skip)
        return F.relu(self.bn1(self.sa(self.cn(y))))


_SCSA_DWC = ("local_dwc", "global_dwc_s", "global_dwc_m", "global_dwc_l")


class SCSA(nn.Module):
    """Spatial-channel synergistic attention (JAX :1815). The map pooled over W and over H; its four channel
    quarters through depthwise 1-D convs of kernel 3, 5, 7, 9 (bare (k, 1, C / 4) parameters and `<name>_bias`,
    shared by both paths), a 4-group GroupNorm (eps 1e-6) and a sigmoid gate the rows and the columns; then the
    map's 7 x 7 average pool (its mean when smaller), a 1-group GroupNorm, bias- and BN-free depthwise 1x1 q, k, v
    (CBAs), attention over the head_dim channels of each head, averaged over the positions, gate the channels."""

    def __init__(self, dim: int, head_num: int = 8, window_size: int = 7,
                 group_kernel_sizes: Sequence[int] = (3, 5, 7, 9)):
        super().__init__()
        gc = dim // 4
        self.head_num, self.window_size, self.gc = head_num, window_size, gc
        for name, k in zip(_SCSA_DWC, group_kernel_sizes):
            bound = math.sqrt(6.0 / k)  # the JAX kaiming_uniform over the kernel's k taps
            self.register_parameter(name, nn.Parameter(torch.empty(k, 1, gc).uniform_(-bound, bound)))
            self.register_parameter(name + "_bias", nn.Parameter(torch.zeros(gc)))
        self.norm_h = nn.GroupNorm(4, dim, eps=LN_EPS)
        self.norm_w = nn.GroupNorm(4, dim, eps=LN_EPS)
        self.norm = nn.GroupNorm(1, dim, eps=LN_EPS)
        self.q = CBA(dim, dim, 1, g=dim, act="none", bn=False)
        self.k = CBA(dim, dim, 1, g=dim, act="none", bn=False)
        self.v = CBA(dim, dim, 1, g=dim, act="none", bn=False)

    def multi_dwc(self, v: torch.Tensor) -> torch.Tensor:
        """The four depthwise 1-D convs over (B, C, L), a channel quarter each."""
        gc, parts = self.gc, []
        for i, name in enumerate(_SCSA_DWC):
            wgt = getattr(self, name)
            k = wgt.shape[0]
            parts.append(F.conv1d(v[:, i * gc:(i + 1) * gc], wgt.permute(2, 1, 0).to(v.dtype),
                                  getattr(self, name + "_bias").to(v.dtype), padding=k // 2, groups=gc))
        return torch.cat(parts, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        h_attn = torch.sigmoid(self.norm_h(self.multi_dwc(x.mean(3))))  # (B, C, H)
        w_attn = torch.sigmoid(self.norm_w(self.multi_dwc(x.mean(2))))  # (B, C, W)
        x = x * h_attn[:, :, :, None] * w_attn[:, :, None, :]
        ws = self.window_size
        y = self.norm(avg_pool(x, ws, ws) if min(h, w) >= ws else _gap(x))
        hd = c // self.head_num
        q, k, v = (t.reshape(b, self.head_num, hd, -1) for t in (self.q(y), self.k(y), self.v(y)))
        attn = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, -1)
        return torch.sigmoid((attn @ v).mean(-1).reshape(b, c, 1, 1)) * x


class _ChannelGate(nn.Module):
    """FGFP's channel gate (JAX :1880): bias-free 1x1 f1 -> ReLU -> f2 over the mean and the max, summed, sigmoid;
    returns the gate."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        self.f1 = nn.Conv2d(c1, max(1, c1 // ratio), 1, bias=False)
        self.f2 = nn.Conv2d(max(1, c1 // ratio), c1, 1, bias=False)

    def forward(self, x):
        return torch.sigmoid(self.f2(F.relu(self.f1(_gap(x)))) + self.f2(F.relu(self.f1(_gmp(x)))))


class FGFP(nn.Module):
    """Fine-grained feature pyramid (JAX :1897): a biased 1x1 `conv_compress` to c2 (c1 / 2), a nearest x2
    upsample, biased 3x3s `conv_refine1` (to c2 / 2) and `conv_refine2` (back to c2; conv3x3 sites, `BiasConv`)
    around the channel gate, a 2x2 max pool, concatenated after the input into a biased 1x1 `conv_final` to c1."""

    def __init__(self, c1: int, c2: Optional[int] = None, ratio: int = 16):
        super().__init__()
        c2 = c2 or c1 // 2
        self.conv_compress = nn.Conv2d(c1, c2, 1)
        self.conv_refine1 = BiasConv(c2, c2 // 2, 3)
        self.channel_attention = _ChannelGate(c2 // 2, ratio)
        self.conv_refine2 = BiasConv(c2 // 2, c2, 3)
        self.conv_final = nn.Conv2d(c1 + c2, c1, 1)

    def forward(self, x):
        h, w = x.shape[2:]
        up = self.conv_refine1(resize_nearest(self.conv_compress(x), 2 * h, 2 * w))
        up = max_pool(self.conv_refine2(self.channel_attention(up) * up), 2, 2)
        return self.conv_final(torch.cat([x, up], 1))


class FGFP_Head(nn.Module):
    """FGFP's head enhancer (JAX :1929): a biased 1x1 `conv1` to c1 / 2, gated by a bias-free 7x7 `sa_conv` over
    its [mean, max], a biased 3x3 `conv2` back to c1 (a conv3x3 site), plus the input."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c1, c1 // 2, 1)
        self.sa_conv = nn.Conv2d(2, 1, 7, padding=3, bias=False)
        self.conv2 = BiasConv(c1 // 2, c1, 3)

    def forward(self, x):
        y = self.conv1(x)
        gate = self.sa_conv(torch.cat([y.mean(1, keepdim=True), y.amax(1, keepdim=True)], 1))
        return self.conv2(torch.sigmoid(gate) * y) + x


# -- the axial image transformer (JAX :1948-2003) -----------------------------------------------------------------


class _AxialSelfAttention(nn.Module):
    """Attention along one axis over (B*, L, C) (JAX :1948): bias-free `to_q` and `to_kv` Linears, heads of
    dim / heads channels at scale 1/sqrt(dim / heads) through SDPA, a biased `to_out`."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_kv = nn.Linear(dim, 2 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, d = x.shape
        e = self.dim // self.heads
        k, v = self.to_kv(x).split(self.dim, -1)
        q, k, v = (z.reshape(b, t, self.heads, e).transpose(1, 2) for z in (self.to_q(x), k, v))
        return self.to_out(F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, d))


class AxialImageTransformer(nn.Module):
    """The axial image transformer (JAX :1974): per depth i a LayerNorm (eps 1e-6) and attention along the columns
    (`d<i>_norm_h`, `d<i>_attn_h`), the same along the rows (`_w`), each added, then two conv FFNs `d<i>_ff<j>`: a
    LayerNorm, a biased 3x3 to 4 * dim, leaky ReLU (0.01), a biased 3x3 back, added. The 3x3s are conv3x3 sites
    with the `none` epilogue (`BiasConv`); the leaky ReLU runs after the kernel. The JAX module's rematerialisation
    (standing for the reference's reversible sequence) changes no value and is not ported."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            for a in ("h", "w"):
                self.add_module(f"d{i}_norm_{a}", nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(f"d{i}_attn_{a}", _AxialSelfAttention(dim, heads))
            for j in range(2):
                self.add_module(f"d{i}_ff{j}_norm", nn.LayerNorm(dim, eps=LN_EPS))
                self.add_module(f"d{i}_ff{j}_c1", BiasConv(dim, 4 * dim, 3))
                self.add_module(f"d{i}_ff{j}_c2", BiasConv(4 * dim, dim, 3))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)  # (B, H, W, C), as the JAX module runs
        b, h, w, c = x.shape
        for i in range(self.depth):
            y = getattr(self, f"d{i}_norm_h")(x).transpose(1, 2).reshape(b * w, h, c)
            x = x + getattr(self, f"d{i}_attn_h")(y).reshape(b, w, h, c).transpose(1, 2)
            y = getattr(self, f"d{i}_norm_w")(x).reshape(b * h, w, c)
            x = x + getattr(self, f"d{i}_attn_w")(y).reshape(b, h, w, c)
            for j in range(2):
                y = getattr(self, f"d{i}_ff{j}_norm")(x).permute(0, 3, 1, 2)
                y = F.leaky_relu(getattr(self, f"d{i}_ff{j}_c1")(y), 0.01)
                x = x + getattr(self, f"d{i}_ff{j}_c2")(y).permute(0, 2, 3, 1)
        return x.permute(0, 3, 1, 2)


# -- the backbone families' squeeze-excite (JAX :163) ----------------------------------------------------------------


class SeBlock(nn.Module):
    """GhostNet's / PP-LCNet's squeeze-excite as the fork has it (JAX :163): the pooled map through a biased 1x1 `fc1`
    to c1 / reduction, a ReLU, a biased 1x1 `fc2` back and a plain sigmoid gate (the published blocks gate by a
    hard sigmoid; copied by design)."""

    def __init__(self, c1: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(c1, max(1, c1 // reduction), 1)
        self.fc2 = nn.Conv2d(max(1, c1 // reduction), c1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(_gap(x)))))


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """A LayerNorm over the channels of an NCHW map (flax's LayerNorm over NHWC's last axis)."""
    return ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class _FrameConv:
    """The families' stems read the frame through one conv, which takes the /255 fold (`nn/fuse.py::fold_preprocess`):
    `frame_conv` names it."""

    frame_attr = "conv"

    @property
    def frame_conv(self) -> nn.Module:
        return getattr(self, self.frame_attr)


# -- GhostNet, MobileNeXt, PP-LCNet (JAX :777-867) -------------------------------------------------------------------


class G_bneck(nn.Module):
    """The fork's Ghost bottleneck (JAX :777): a GhostConv to `midc` (the model's default activation), a 3x3 stride-2
    depthwise ConvBN when s = 2, the SeBlock, a linear ghost pair `ghost2_cv1` (1x1 to c2 / 2) and `ghost2_cv2` (5x5
    depthwise), plus the input, or at c1 != c2 or s = 2 its 3x3 depthwise `short_dw` and 1x1 `short_pw`. `k` is
    taken and not read, as in the fork's block."""

    def __init__(self, c1: int, c2: int, midc: int, k: int = 5, s: int = 1, use_se: bool = False):
        super().__init__()
        c_, h = midc, c2 // 2
        self.identity = c1 == c2 and s == 1
        self.ghost1 = GhostConv(c1, c_, 1, 1)
        self.dw = ConvBN(c_, c_, 3, 2, g=c_, act=False) if s == 2 else None
        self.se = SeBlock(c_) if use_se else None
        self.ghost2_cv1 = ConvBN(c_, h, 1, 1, act=False)
        self.ghost2_cv2 = ConvBN(h, h, 5, 1, g=h, act=False)
        if not self.identity:
            self.short_dw = ConvBN(c1, c1, 3, s, g=c1, act=False)
            self.short_pw = ConvBN(c1, c2, 1, 1, act=False)

    def forward(self, x):
        y = self.ghost1(x)
        if self.dw is not None:
            y = self.dw(y)
        if self.se is not None:
            y = self.se(y)
        g1 = self.ghost2_cv1(y)
        y = torch.cat([g1, self.ghost2_cv2(g1)], 1)
        return y + (x if self.identity else self.short_pw(self.short_dw(x)))


SANDGLASS_ACT = "relu6"  # MobileNeXt's; the JAX SGBlock's "relu6" ConvBNs run no activation (ROADMAP Queue 3)


class SGBlock(nn.Module):
    """MobileNeXt's sandglass block in the fork's four layouts (JAX :807), keyed on the expansion, c1 vs c2 and the
    stride: a 3x3 depthwise `dw1` (ReLU6), a linear 1x1 `pw1` to the hidden width, a 1x1 `pw2` (ReLU6) and a linear 3x3
    depthwise `dw2`, or the parts of it a layout keeps; the last layout adds the input unless keep_3x3. Its ReLU6s are
    `SANDGLASS_ACT`, read when the block is built."""

    def __init__(self, c1: int, c2: int, stride: int = 1, expand_ratio: int = 6, keep_3x3: bool = False):
        super().__init__()
        inp, oup, a = c1, c2, SANDGLASS_ACT
        hidden = inp // expand_ratio
        if hidden < oup / 6.0:
            hidden = math.ceil(oup / 6.0)
            hidden = max(16, int(hidden + 8) // 16 * 16)
        self.identity = False
        if expand_ratio == 2:
            layers = (("dw1", inp, 3, 1, inp, a), ("pw1", hidden, 1, 1, 1, "none"), ("pw2", oup, 1, 1, 1, a),
                      ("dw2", oup, 3, stride, oup, "none"))
        elif inp != oup and stride == 1 and not keep_3x3:
            layers = (("pw1", hidden, 1, 1, 1, "none"), ("pw2", oup, 1, 1, 1, a))
        elif inp != oup and stride == 2 and not keep_3x3:
            layers = (("pw1", hidden, 1, 1, 1, "none"), ("pw2", oup, 1, 1, 1, a), ("dw2", oup, 3, stride, oup, "none"))
        else:
            self.identity = not keep_3x3
            layers = (("dw1", inp, 3, 1, inp, a), ("pw1", hidden, 1, 1, 1, "none"), ("pw2", oup, 1, 1, 1, a),
                      ("dw2", oup, 3, 1, oup, "none"))
        c = inp
        self.order = tuple(name for name, *_ in layers)
        for name, co, k, s, g, act in layers:
            self.add_module(name, CBA(c, co, k, s, g=g, act=act))
            c = co

    def forward(self, x):
        y = x
        for name in self.order:
            y = getattr(self, name)(y)
        return x + y if self.identity else y


class DepthSepConv(nn.Module):
    """PP-LCNet's depthwise-separable conv (JAX :849): a k x k stride-s depthwise ConvBN, hard-swish, the SeBlock
    (reduction 16), a 1x1 ConvBN, hard-swish."""

    def __init__(self, c1: int, c2: int, dw_size: int = 3, stride: int = 1, use_se: bool = False):
        super().__init__()
        self.dw = CBA(c1, c1, dw_size, stride, g=c1, act="hswish")
        self.se = SeBlock(c1, reduction=16) if use_se else None
        self.pw = CBA(c1, c2, 1, act="hswish")

    def forward(self, x):
        y = self.dw(x)
        return self.pw(y if self.se is None else self.se(y))


# -- ShuffleNetV2, EfficientNet-Lite, MobileNetV3, LeYOLO (JAX :869-1054) ---------------------------------------------


class CBRM(_FrameConv, nn.Module):
    """ShuffleNetV2's stem (JAX :869): a 3x3 stride-2 CBA (ReLU), then a 3x3 stride-2 max pool padded by 1."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = CBA(c1, c2, 3, 2, act="relu")

    def forward(self, x):
        return max_pool(self.conv(x), 3, 2, 1)


class Shuffle_Block(nn.Module):
    """ShuffleNetV2's unit (JAX :882): at stride 1 the second half of the channels through `b2_pw1` (1x1, ReLU),
    `b2_dw` (3x3 depthwise) and `b2_pw2` (1x1, ReLU) beside the first half; at stride 2 the whole map through that
    branch and through `b1_dw` (3x3 stride-2 depthwise) and `b1_pw` (1x1, ReLU); then a 2-group channel shuffle."""

    def __init__(self, c1: int, c2: int, stride: int = 1):
        super().__init__()
        bf = c2 // 2
        self.stride = stride
        if stride != 1:
            self.b1_dw = CBA(c1, c1, 3, stride, g=c1, act="none")
            self.b1_pw = CBA(c1, bf, 1, act="relu")
        self.b2_pw1 = CBA(c1 if stride != 1 else bf, bf, 1, act="relu")
        self.b2_dw = CBA(bf, bf, 3, stride, g=bf, act="none")
        self.b2_pw2 = CBA(bf, bf, 1, act="relu")

    def branch2(self, x):
        return self.b2_pw2(self.b2_dw(self.b2_pw1(x)))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.branch2(x[:, half:])], 1)
        else:
            out = torch.cat([self.b1_pw(self.b1_dw(x)), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


class stem(_FrameConv, nn.Module):
    """EfficientNet-Lite's stem (JAX :910): a 3x3 stride-2 CBA, ReLU6."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = CBA(c1, c2, 3, 2, act="relu6")

    def forward(self, x):
        return self.conv(x)


class MBConvBlock(nn.Module):
    """EfficientNet-Lite's MBConv (JAX :922): a 1x1 `expand` to c1 * expand_ratio (ReLU6, where the ratio is not 1), a
    k x k stride-s depthwise `dw` (ReLU6), the SeBlock, a linear 1x1 `project`; at stride 1 and c1 == c2 plus the
    input. In training a drop-connect rate zeroes whole samples of the branch (the kept ones divided by the keep
    rate): each sample's draw comes from `generator`, a CPU torch.Generator seeded 0."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, expand_ratio: int = 1, drop_connect_rate: float = 0.0,
                 has_se: bool = False):
        super().__init__()
        oup = c1 * expand_ratio
        self.residual = s == 1 and c1 == c2
        self.drop_connect_rate = drop_connect_rate
        self.generator = torch.Generator().manual_seed(0)
        self.expand = CBA(c1, oup, 1, act="relu6") if expand_ratio != 1 else None
        self.dw = CBA(oup, oup, k, s, g=oup, act="relu6")
        self.se = SeBlock(oup, 4) if has_se else None
        self.project = CBA(oup, c2, 1, act="none")

    def drop_connect(self, y: torch.Tensor) -> torch.Tensor:
        keep = 1.0 - self.drop_connect_rate
        draw = torch.rand((y.shape[0], 1, 1, 1), generator=self.generator)
        draw = (draw.pin_memory() if y.is_cuda else draw).to(y.device, non_blocking=True)
        return y / keep * torch.floor(keep + draw).to(y.dtype)

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.dw(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        if not self.residual:
            return y
        if self.training and self.drop_connect_rate:
            y = self.drop_connect(y)
        return y + x


class Conv_BN_HSwish(_FrameConv, nn.Module):
    """MobileNetV3's stem conv (JAX :957): a 3x3 stride-s CBA, hard-swish."""

    def __init__(self, c1: int, c2: int, stride: int = 1):
        super().__init__()
        self.conv = CBA(c1, c2, 3, stride, act="hswish")

    def forward(self, x):
        return self.conv(x)


class MobileNetV3_InvertedResidual(nn.Module):
    """MobileNetV3's inverted residual (JAX :970): at c1 == hidden_dim a k x k depthwise `dw` (ReLU or hard-swish),
    the SeBlock, a linear 1x1 `pw`; else a 1x1 `pw1` to hidden_dim (the activation), a linear depthwise `dw`, the
    SeBlock, the activation, a linear 1x1 `pw2`. At stride 1 and c1 == c2 plus the input."""

    def __init__(self, c1: int, c2: int, hidden_dim: int = 16, kernel_size: int = 3, stride: int = 1,
                 use_se: bool = False, use_hs: bool = False):
        super().__init__()
        hd, k = hidden_dim, kernel_size
        self.act = "hswish" if use_hs else "relu"
        self.expand = c1 != hd
        self.residual = stride == 1 and c1 == c2
        if self.expand:
            self.pw1 = CBA(c1, hd, 1, act=self.act)
        self.dw = CBA(hd, hd, k, stride, g=hd, act="none" if self.expand else self.act)
        self.se = SeBlock(hd) if use_se else None
        if self.expand:
            self.pw2 = CBA(hd, c2, 1, act="none")
        else:
            self.pw = CBA(hd, c2, 1, act="none")

    def forward(self, x):
        y = self.dw(self.pw1(x) if self.expand else x)
        if self.se is not None:
            y = self.se(y)
        y = self.pw2(_act(y, self.act)) if self.expand else self.pw(y)
        return x + y if self.residual else y


_LEYOLO_ACT = {"RE": "relu6", "GE": "gelu", "SI": "silu", "EL": "elu"}  # any other name: hard-swish


class mn_conv(_FrameConv, nn.Module):
    """LeYOLO's conv-BN-activation (JAX :1004): a k x k stride-s CBA `c`, unpadded when k == s; act "RE" ReLU6, "GE"
    GELU, "SI" SiLU, "EL" ELU, any other hard-swish."""

    frame_attr = "c"

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: str = "RE"):
        super().__init__()
        self.c = CBA(c1, c2, k, s, p=0 if k == s else autopad(k), act=_LEYOLO_ACT.get(act, "hswish"))

    def forward(self, x):
        return self.c(x)


class InvertedBottleneck(nn.Module):
    """LeYOLO's inverted bottleneck (JAX :1021): with `pw` an mn_conv 1x1 to e (c1 where e is None), a k x k
    stride-s depthwise CBA `dw` (the activation), a biased 1x1 `proj` with no BatchNorm of its own, then `bn`; at
    stride 1 and c1 == c2 plus the input. Folded, `proj` takes `bn` in. `sa` is taken and not read, as in the JAX
    module (LeYOLO's squeeze-excite is not built)."""

    def __init__(self, c1: int, c2: int, k: int = 3, e: Optional[int] = None, sa="None", act: str = "RE",
                 stride: int = 1, pw: bool = True):
        super().__init__()
        c_mid = e if e is not None else c1
        self.residual = c1 == c2 and stride == 1
        self.pw = mn_conv(c1, c_mid, act=act) if pw else None
        self.dw = CBA(c_mid, c_mid, k, stride, g=c_mid, act=_LEYOLO_ACT.get(act, "hswish"))
        self.proj = CBA(c_mid, c2, 1, act="none", bias=True, bn=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.proj.post_bn = (self.bn,)

    def forward(self, x):
        y = self.proj(self.dw(x if self.pw is None else self.pw(x)))
        if not folds_bn(self.proj):
            y = self.bn(y)
        return x + y if self.residual else y


class MobileNetV3_BLOCK(InvertedBottleneck):
    """LeYOLO's MobileNetV3 block, InvertedBottleneck's alias (JAX :1053)."""


# -- Swin (JAX :1062-1237) --------------------------------------------------------------------------------------------


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws, ws, C) (JAX :1062)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3).reshape(-1, ws, ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B * nW, ws, ws, C) -> (B, H, W, C) (JAX :1069)."""
    b = windows.shape[0] // (h * w // ws // ws)
    return windows.reshape(b, h // ws, w // ws, ws, ws, -1).transpose(2, 3).reshape(b, h, w, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """The (ws², ws²) index into the (2ws - 1)² bias table (JAX :1075)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _swin_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' mask (nW, ws², ws²) on the padded (hp, wp) map, 0 within a region, -100 across (JAX
    :1087, the reference's create_mask)."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, hp // ws, ws, wp // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# the index and the masks, made once a shape and device; made outside inference mode, so that a model that served
# under torch.inference_mode() can train on them
@functools.lru_cache(maxsize=64)
def _swin_index(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_relative_position_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=64)
def _swin_mask(hp: int, wp: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_swin_attn_mask(hp, wp, ws, shift)).to(device)


class WindowAttention(nn.Module):
    """Window multi-head self-attention with a relative position bias (JAX :1100): a `qkv` Linear, heads of dim / nh
    channels at scale 1/sqrt(dim / nh), the bias gathered from the f32 `relative_position_bias_table` ((2ws - 1)², nh)
    and the shifted windows' mask added to the logits (SDPA's `attn_mask`, the windows folded into the heads), a
    `proj` Linear. x is (B * nW, ws², C); the mask (nW, ws², ws²) or None."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.ws, self.nh = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(torch.empty((2 * window_size - 1) ** 2, num_heads), std=0.02, a=-0.04, b=0.04))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        nh, hd = self.nh, c // self.nh
        q, k, v = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)  # (B_, nh, N, hd) each
        table = self.relative_position_bias_table
        bias = table[_swin_index(self.ws, x.device)].view(n, n, nh).permute(2, 0, 1).float()  # (nh, N, N)
        if mask is None:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(q.dtype), scale=hd ** -0.5)
        else:
            nw = mask.shape[0]
            m = (bias[None] + mask[:, None]).to(q.dtype).reshape(1, nw * nh, n, n)
            fold = lambda t: t.reshape(b_ // nw, nw * nh, n, hd)  # noqa: E731
            out = F.scaled_dot_product_attention(fold(q), fold(k), fold(v), attn_mask=m, scale=hd ** -0.5)
        return self.proj(out.reshape(b_, nh, n, hd).transpose(1, 2).reshape(b_, n, c))


class SwinTransformerBlock(nn.Module):
    """A Swin block on (B, H, W, C) (JAX :1136): `norm1`, the map padded at the bottom and right to a multiple of the
    window, rolled back by the shift where there is one (the mask built on the padded size), window attention, the
    roll and the pad undone, plus the input; `norm2`, `fc1` to mlp_ratio * C, GELU (tanh), `fc2`, plus. The
    LayerNorms take flax's eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws, self.shift = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = _swin_mask(hp, wp, ws, shift, x.device)
        x = self.attn(_window_partition(x, ws).reshape(-1, ws * ws, c), mask)
        x = _window_reverse(x.reshape(-1, ws, ws, c), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        x = shortcut + x
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class SwinStage(nn.Module):
    """`depth` Swin blocks (`blocks.<i>`), the odd ones shifted by half a window (JAX :1178); dim == c2."""

    def __init__(self, dim: int, c2: int, depth: int, num_heads: int, window_size: int):
        super().__init__()
        if dim != c2:
            raise ValueError(f"SwinStage keeps its width: dim {dim} != c2 {c2}")
        self.blocks = nn.ModuleList(SwinTransformerBlock(dim, num_heads, window_size,
                                                         0 if i % 2 == 0 else window_size // 2) for i in range(depth))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class PatchEmbed(_FrameConv, nn.Module):
    """Swin's patch embedding (JAX :1200): the map padded at the bottom and right to a multiple of the patch, a
    biased p x p stride-p conv `proj` (a `BiasConv`), a LayerNorm `norm` over the channels."""

    frame_attr = "proj"

    def __init__(self, c1: int, c2: int, patch_size: int = 4):
        super().__init__()
        self.p = patch_size
        self.proj = BiasConv(c1, c2, patch_size, patch_size, p=0)
        self.norm = nn.LayerNorm(c2, eps=LN_EPS)

    def forward(self, x):
        p, (h, w) = self.p, x.shape[2:]
        if h % p or w % p:
            x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p))
        return _ln(self.proj(x), self.norm)


class PatchMerging(nn.Module):
    """Swin's 2x2 patch merging (JAX :1218): an odd map padded by one, the four pixels of each 2x2 concatenated
    [x0 (even row, even column), x1 (odd, even), x2 (even, odd), x3 (odd, odd)], a LayerNorm `norm`, a bias-free
    Linear `reduction` to 2 * dim; c2 == 2 * dim."""

    def __init__(self, dim: int, c2: int):
        super().__init__()
        if c2 != 2 * dim:
            raise ValueError(f"PatchMerging doubles the width: c2 {c2} != 2 * {dim}")
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[2:]
        if h % 2 or w % 2:
            x = F.pad(x, (0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], 1)
        return self.reduction(self.norm(x.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)


# -- VanillaNet, ConvNeXt, StarNet, FasterNet (JAX :1245-1412) -------------------------------------------------------


class VanillaBlock(nn.Module):
    """VanillaNet's block (JAX :1245): a biased 1x1 CBA `conv1` (BN, no activation) at dim, `conv2` to dim_out alike, a
    stride x stride max pool, a ReLU, then the series activation `act`: a (2 act_num + 1)² depthwise CBA (BN, no
    activation). The deep-training leaky ReLU at act_learn 1 is the identity and is left out, as in the JAX module;
    the published series activation's conv bias (before its BN) is not built, as there."""

    def __init__(self, dim: int, dim_out: int, act_num: int = 3, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv1 = CBA(dim, dim, 1, act="none", bias=True)
        self.conv2 = CBA(dim, dim_out, 1, act="none", bias=True)
        self.act = CBA(dim_out, dim_out, 2 * act_num + 1, p=act_num, g=dim_out, act="none")

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        if self.stride != 1:
            x = max_pool(x, self.stride, self.stride)
        return self.act(F.relu(x))


class ConvNeXt_Stem(_FrameConv, nn.Module):
    """ConvNeXt's stem (JAX :1270): a biased k x k stride-s unpadded conv (`BiasConv`), a LayerNorm `ln` (eps 1e-6)."""

    def __init__(self, c1: int, c2: int, k: int = 4, s: int = 4):
        super().__init__()
        self.conv = BiasConv(c1, c2, k, s, p=0)
        self.ln = nn.LayerNorm(c2, eps=LN_EPS)

    def forward(self, x):
        return _ln(self.conv(x), self.ln)


class ConvNeXt_Downsample(nn.Module):
    """ConvNeXt's downsample (JAX :1286): a LayerNorm `ln`, then a biased k x k stride-s unpadded conv."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2):
        super().__init__()
        self.ln = nn.LayerNorm(c1, eps=LN_EPS)
        self.conv = BiasConv(c1, c2, k, s, p=0)

    def forward(self, x):
        return self.conv(_ln(x, self.ln))


class ConvNeXt_Block(nn.Module):
    """n ConvNeXt blocks (JAX :1302), each `m.<i>_dwconv` (a biased 7x7 depthwise CBA, no BN), `m.<i>_norm`
    (LayerNorm, eps 1e-6), `m.<i>_pwconv1` (Linear to 4 * dim), GELU (tanh), `m.<i>_pwconv2`, times the layer scale
    `m_<i>_gamma`, plus its input; dim = c2."""

    def __init__(self, c1: int, c2: int, n: int = 1, layer_scale_init_value: float = 1e-6):
        super().__init__()
        dim = c2
        self.n = n
        self.m = nn.ModuleDict()
        for i in range(n):
            self.m[f"{i}_dwconv"] = CBA(c1 if i == 0 else dim, dim, 7, g=dim, act="none", bias=True, bn=False)
            self.m[f"{i}_norm"] = nn.LayerNorm(dim, eps=LN_EPS)
            self.m[f"{i}_pwconv1"] = nn.Linear(dim, 4 * dim)
            self.m[f"{i}_pwconv2"] = nn.Linear(4 * dim, dim)
            if layer_scale_init_value > 0:
                self.register_parameter(f"m_{i}_gamma", nn.Parameter(torch.full((dim,), layer_scale_init_value)))

    def forward(self, x):
        for i in range(self.n):
            m = self.m
            y = m[f"{i}_dwconv"](x).permute(0, 2, 3, 1)
            y = m[f"{i}_pwconv2"](_gelu(m[f"{i}_pwconv1"](m[f"{i}_norm"](y))))
            gamma = getattr(self, f"m_{i}_gamma", None)
            x = x + (y if gamma is None else y * gamma).permute(0, 3, 1, 2)
        return x


class StarBlock(nn.Module):
    """StarNet's blocks (JAX :1330; Ma et al., 2024): n of them in sequence, each a 7x7 depthwise CBA `dwconv.<i>`
    (conv bias and BN), the star op ReLU6(`f1.<i>`(x)) * `f2.<i>`(x) (biased 1x1s to mlp_ratio * dim, no BN), a 1x1
    `g.<i>` (bias and BN), a 7x7 depthwise `dwconv2.<i>` (bias, no BN), plus the block's input: a residual around
    each block, as the published StarNet stacks them. The JAX module adds one residual around all n
    (ROADMAP Queue 3)."""

    def __init__(self, dim: int, mlp_ratio: int = 3, n: int = 1):
        super().__init__()
        d, r = dim, mlp_ratio
        self.n = n
        self.dwconv = nn.ModuleList(CBA(d, d, 7, g=d, act="none", bias=True) for _ in range(n))
        self.f1 = nn.ModuleList(CBA(d, d * r, 1, act="none", bias=True, bn=False) for _ in range(n))
        self.f2 = nn.ModuleList(CBA(d, d * r, 1, act="none", bias=True, bn=False) for _ in range(n))
        self.g = nn.ModuleList(CBA(d * r, d, 1, act="none", bias=True) for _ in range(n))
        self.dwconv2 = nn.ModuleList(CBA(d, d, 7, g=d, act="none", bias=True, bn=False) for _ in range(n))

    def star(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block i without its residual."""
        x = self.dwconv[i](x)
        x = _act(self.f1[i](x), "relu6") * self.f2[i](x)
        return self.dwconv2[i](self.g[i](x))

    def forward(self, x):
        for i in range(self.n):
            x = x + self.star(i, x)
        return x


class BasicStage(nn.Module):
    """FasterNet's stage (JAX :1353): `depth` blocks, each a partial 3x3 conv `b<i>_pconv` over the first dim // n_div
    channels (bias-free, a conv3x3 site with the `none` epilogue and a zero bias once folded), the rest passed,
    then `b<i>_mlp1` (1x1 CBA to mlp_ratio * dim, ReLU) and `b<i>_mlp2` (bias-free 1x1 back), plus the block's
    input."""

    def __init__(self, dim: int, depth: int = 1, n_div: int = 4, mlp_ratio: int = 2):
        super().__init__()
        self.depth, self.dc = depth, dim // n_div
        for i in range(depth):
            self.add_module(f"b{i}_pconv", BiasConv(self.dc, self.dc, 3, bias=False))
            self.add_module(f"b{i}_mlp1", CBA(dim, dim * mlp_ratio, 1, act="relu"))
            self.add_module(f"b{i}_mlp2", BiasConv(dim * mlp_ratio, dim, 1, bias=False))

    def forward(self, x):
        dc = self.dc
        for i in range(self.depth):
            y = torch.cat([getattr(self, f"b{i}_pconv")(x[:, :dc]), x[:, dc:]], 1)
            x = x + getattr(self, f"b{i}_mlp2")(getattr(self, f"b{i}_mlp1")(y))
        return x


class _ConvNorm(_FrameConv, nn.Module):
    """A bias-free unpadded k x k stride-s conv and its BatchNorm `norm`, the conv under the JAX module's name
    (`frame_attr`); folded, the conv takes the BatchNorm in."""

    frame_attr = "proj"

    def __init__(self, c1: int, c2: int, k: int, s: int):
        super().__init__()
        conv = BiasConv(c1, c2, k, s, p=0, bias=False)
        self.add_module(self.frame_attr, conv)
        self.norm = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        conv.post_bn = (self.norm,)

    def forward(self, x):
        conv = self.frame_conv
        y = conv(x)
        return y if folds_bn(conv) else self.norm(y)


class PatchEmbed_FasterNet(_ConvNorm):
    """FasterNet's patch embedding (JAX :1379): a bias-free patch_size conv of stride patch_stride `proj`, BN `norm`."""

    def __init__(self, c1: int, c2: int, patch_size: int = 4, patch_stride: int = 4):
        super().__init__(c1, c2, patch_size, patch_stride)


class PatchMerging_FasterNet(_ConvNorm):
    """FasterNet's patch merging (JAX :1397): a bias-free k x k conv of stride patch_stride2 `reduction`, BN `norm`."""

    frame_attr = "reduction"

    def __init__(self, c1: int, c2: int, k: int = 2, patch_stride2: int = 2):
        super().__init__(c1, c2, k, patch_stride2)


def build_research_module(m: str, a: tuple) -> nn.Module:
    """One module of the research zoo from its compiled (name, args), as the JAX `build_research_module`
    (:2050-2068): SKAttention's kernels and ASFF's widths as tuples."""
    if m not in PORTED:
        raise NotImplementedError(f"research module '{m}' is not ported to torch yet")
    if m == "SKAttention" and len(a) > 1:
        a = (a[0], tuple(a[1]), *a[2:])
    if m in MULTI_INPUT:
        a = (tuple(a[0]), *a[1:])
    return globals()[m](*a)


def _lpc_cfg() -> Dict[str, Any]:
    import yaml

    return yaml.safe_load(LPC_YAML.read_text())


def _set_layer(d: Dict[str, Any], i: int, module: str, args: list, old: str) -> None:
    """Replace layer i (a `old` layer) by `module`, keeping its `from` and its repeats."""
    layers = d["backbone"] + d["head"]
    f, n, m, _ = layers[i]
    assert m == old, (i, m, old)
    part, j = (d["backbone"], i) if i < len(d["backbone"]) else (d["head"], i - len(d["backbone"]))
    part[j] = [f, n, module, args]


def lpc_attention_cfg(module: str) -> Dict[str, Any]:
    """The LPC-YOLO YAML (at its `s` scale) with layer 21's `CBAM [7]` replaced by an attention module: args
    `[128]` (64 at the 0.5 width) for the width-scaled CoordAtt and GAMAttention, `[]` for the others; no index
    moves."""
    if module not in ATTENTION:
        raise ValueError(f"{module!r} is not one of the zoo's attention modules")
    d = _lpc_cfg()
    _set_layer(d, LPC_ATTENTION_LAYER, module, [128] if module in WIDTH_SCALED else [], "CBAM")
    return d


def write_lpc_attention_yaml(module: str, directory: Union[str, Path]) -> Path:
    """`lpc_attention_cfg(module)` written as `yolov10s-LPC-<module>.yaml` under `directory` (the scale letter in
    the name, as the facade reads it)."""
    return _write_yaml(lpc_attention_cfg(module), Path(directory) / f"yolov10s-LPC-{module}.yaml")


def _write_yaml(d: Dict[str, Any], path: Path) -> Path:
    import yaml

    path.write_text(yaml.safe_dump(d, sort_keys=False))
    return path


# LPC-YOLO's neck layers (at 640, s width): the C2fs 17 (40² x 128), 20 (80² x 64), 24 (40² x 128) and 27
# (20² x 256, which no layer reads), the LPC downsamples 22 and 25, the upsamples 15 and 18, the SPPF 13;
# v10Detect (28) reads 20, 23 and 26 (64, 192 and 384 channels)
_NECK_C2F = {17: 256, 20: 128, 24: 256, 27: 512}
_NECK_LPC = {22: 128, 25: 256}
# the slice's variants: each one's neck blocks (the module names it puts on the path)
NECK_VARIANTS = {
    "slimneck": ("GSConv", "VoVGSCSP"), "slimneck_cheap": ("GSConvns", "VoVGSCSPC"),
    "msblock": ("MSBlock", "C2f_MSBlock"), "dysample": ("DySample",), "rfb": ("BasicRFB",), "PPA": ("PPA",),
    "SCSA": ("SCSA",), "FGFP": ("FGFP",), "FGFP_Head": ("FGFP_Head",),
    "AxialImageTransformer": ("AxialImageTransformer",), "asff3": ("ASFF3",), "asff2": ("ASFF2",),
}


def lpc_neck_cfg(variant: str) -> Dict[str, Any]:
    """The LPC-YOLO YAML (at its `s` scale) with a neck block of the research zoo where it fits, no layer index
    before the change moving: "slimneck" (the C2fs 17/20/24/27 -> `VoVGSCSP [c]`, the LPCs 22/25 -> `GSConv [c, 3,
    2]`), "slimneck_cheap" (as slimneck with `VoVGSCSPC`, and layer 21 -> `GSConvns [128]`), "msblock" (the C2fs ->
    `C2f_MSBlock [c]`, layer 21 -> `MSBlock [128, [1, 3, 3]]`), "dysample" (the upsamples 15/18 -> `DySample [2,
    lp]`), "rfb" (the SPPF 13 -> `BasicRFB [512]`), "PPA" / "SCSA" / "FGFP" / "FGFP_Head" / "AxialImageTransformer"
    (layer 21's CBAM -> the block, `[128]` for PPA, `[]` for the others), "asff3" (`ASFF3 [64, level]` over [20, 23,
    26] at levels 0, 1, 2 as layers 28-30, v10Detect at 31 on them) and "asff2" (`ASFF2 [64, level]` over [20, 23]
    at levels 0, 1 as layers 28-29, v10Detect at 30 on [28, 29, 26])."""
    if variant not in NECK_VARIANTS:
        raise ValueError(f"{variant!r} is not one of the neck variants {sorted(NECK_VARIANTS)}")
    d = _lpc_cfg()
    if variant.startswith("slimneck"):
        for i, c in _NECK_C2F.items():
            _set_layer(d, i, "VoVGSCSPC" if variant == "slimneck_cheap" else "VoVGSCSP", [c], "C2f")
        for i, c in _NECK_LPC.items():
            _set_layer(d, i, "GSConv", [c, 3, 2], "LPC")
        if variant == "slimneck_cheap":
            _set_layer(d, LPC_ATTENTION_LAYER, "GSConvns", [128], "CBAM")
    elif variant == "msblock":
        for i, c in _NECK_C2F.items():
            _set_layer(d, i, "C2f_MSBlock", [c], "C2f")
        _set_layer(d, LPC_ATTENTION_LAYER, "MSBlock", [128, [1, 3, 3]], "CBAM")
    elif variant == "dysample":
        for i in (15, 18):
            _set_layer(d, i, "DySample", [2, "lp"], "nn.Upsample")
    elif variant == "rfb":
        _set_layer(d, 13, "BasicRFB", [512], "SPPF")
    elif variant.startswith("asff"):
        head = d["head"].pop()
        assert head[2] == "v10Detect" and head[0] == [20, 23, 26], head
        levels = (20, 23, 26) if variant == "asff3" else (20, 23)
        first = len(d["backbone"]) + len(d["head"])
        for level in range(len(levels)):
            d["head"].append([list(levels), 1, variant.upper(), [64, level]])
        feeds = list(range(first, first + len(levels))) + ([] if variant == "asff3" else [26])
        d["head"].append([feeds, 1, "v10Detect", head[3]])
    else:
        _set_layer(d, LPC_ATTENTION_LAYER, variant, [128] if variant in WIDTH_SCALED else [], "CBAM")
    return d


def write_lpc_neck_yaml(variant: str, directory: Union[str, Path]) -> Path:
    """`lpc_neck_cfg(variant)` written as `yolov10s-LPC-<variant>.yaml` under `directory`."""
    return _write_yaml(lpc_neck_cfg(variant), Path(directory) / f"yolov10s-LPC-{variant}.yaml")


# -- LPC-YOLO with a backbone family of the research zoo ---------------------------------------------------------------

# LPC-YOLO's backbone is layers 0-14; its neck reads layer 7 (stride 8), 10 (stride 16) and 14 (stride 32, the PSA)
_LPC_READS = {7: "p3", 10: "p4", 14: "p5"}
_LPC_TAIL = [[-1, 1, "SPPF", [512, 5]], [-1, 1, "PSA", [512]]]
# each variant's stages (YAML rows before the LPC tail, SPPF and PSA) and the indices of its stride-8 and stride-16
# outputs among them. Channel args are at the YAML's 1.0 width: LPC-YOLO's s scale halves them, 512 and up to 256.
BACKBONE_VARIANTS: Dict[str, Dict[str, Any]] = {
    # Swin-T (patch 4, window 7, depths 2-2-6-2, head dim 32) at a third of its width: 32, 64, 128, 256
    "swin": {"p3": 3, "p4": 5, "rows": [
        [-1, 1, "PatchEmbed", [64, 4]], [-1, 1, "SwinStage", [64, 2, 1, 7]],
        [-1, 1, "PatchMerging", [128]], [-1, 1, "SwinStage", [128, 2, 2, 7]],
        [-1, 1, "PatchMerging", [256]], [-1, 1, "SwinStage", [256, 6, 4, 7]],
        [-1, 1, "PatchMerging", [512]], [-1, 1, "SwinStage", [512, 2, 8, 7]]]},
    # ConvNeXt-T (stem 4x4, depths 3-3-9-3 cut by the s depth to 1-1-3-1, downsamples 2x2): 32, 64, 128, 256
    "convnext": {"p3": 3, "p4": 5, "rows": [
        [-1, 1, "ConvNeXt_Stem", [64, 4, 4]], [-1, 3, "ConvNeXt_Block", [64]],
        [-1, 1, "ConvNeXt_Downsample", [128, 2, 2]], [-1, 3, "ConvNeXt_Block", [128]],
        [-1, 1, "ConvNeXt_Downsample", [256, 2, 2]], [-1, 9, "ConvNeXt_Block", [256]],
        [-1, 1, "ConvNeXt_Downsample", [512, 2, 2]], [-1, 3, "ConvNeXt_Block", [512]]]},
    # VanillaNet-6 (a 4x4 stride-4 stem, stages of stride 2, 2, 2, 1, series activation 3): 64, 128, 256, 256, 256
    "vanillanet": {"p3": 1, "p4": 2, "rows": [
        [-1, 1, "Conv", [128, 4, 4, 0]], [-1, 1, "VanillaBlock", [256, 3, 2]], [-1, 1, "VanillaBlock", [512, 3, 2]],
        [-1, 1, "VanillaBlock", [512, 3, 2]], [-1, 1, "VanillaBlock", [512, 3, 1]]]},
    # StarNet-S2 (stem 32, strided 3x3 downsamplers, depths 1-2-6-2 cut to 1-1-2-1, mlp ratio 3): 32, 64, 128, 256
    "starnet": {"p3": 4, "p4": 6, "rows": [
        [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "StarBlock", [3]],
        [-1, 1, "Conv", [128, 3, 2]], [-1, 2, "StarBlock", [3]], [-1, 1, "Conv", [256, 3, 2]],
        [-1, 6, "StarBlock", [3]], [-1, 1, "Conv", [512, 3, 2]], [-1, 2, "StarBlock", [3]]]},
    # FasterNet-T1 (patch 4, depths 1-2-8-2, n_div 4, mlp ratio 2, 2x2 mergings) at half width: 32, 64, 128, 256
    "fasternet": {"p3": 3, "p4": 5, "rows": [
        [-1, 1, "PatchEmbed_FasterNet", [64, 4, 4]], [-1, 1, "BasicStage", [1]],
        [-1, 1, "PatchMerging_FasterNet", [128, 2, 2]], [-1, 1, "BasicStage", [2]],
        [-1, 1, "PatchMerging_FasterNet", [256, 2, 2]], [-1, 1, "BasicStage", [8]],
        [-1, 1, "PatchMerging_FasterNet", [512, 2, 2]], [-1, 1, "BasicStage", [2]]]},
    # MobileNetV3-Large's 15 bnecks (k, expansion, SE, hard-swish, stride as published), widths and expansions at
    # half: 8, 16, 24, 40 / 56 / 80, 80
    "mobilenetv3": {"p3": 6, "p4": 12, "rows": [
        [-1, 1, "Conv_BN_HSwish", [16, 2]],
        [-1, 1, "MobileNetV3_InvertedResidual", [16, 8, 3, 1, 0, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [24, 32, 3, 2, 0, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [24, 36, 3, 1, 0, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [40, 36, 5, 2, 1, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [40, 60, 5, 1, 1, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [40, 60, 5, 1, 1, 0]],
        [-1, 1, "MobileNetV3_InvertedResidual", [80, 120, 3, 2, 0, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [80, 100, 3, 1, 0, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [80, 92, 3, 1, 0, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [80, 92, 3, 1, 0, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [112, 240, 3, 1, 1, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [112, 336, 3, 1, 1, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [160, 336, 5, 2, 1, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [160, 480, 5, 1, 1, 1]],
        [-1, 1, "MobileNetV3_InvertedResidual", [160, 480, 5, 1, 1, 1]]]},
    # LeYOLO-small's backbone (an mn_conv stem, its second conv 3x3 stride 1 here; MobileNetV3_BLOCK /
    # InvertedBottleneck, ReLU6 to stride 8, hard-swish after; `sa` off, as the JAX block never builds it; repeats
    # 3 and 4 cut by the s depth to 1): 8, 8, 16, 32, 48
    "leyolo": {"p3": 4, "p4": 6, "rows": [
        [-1, 1, "mn_conv", [16, 3, 2]], [-1, 1, "mn_conv", [16, 3, 1]],
        [-1, 1, "MobileNetV3_BLOCK", [16, 3, 16, "None", "RE", 2, False]],
        [-1, 1, "MobileNetV3_BLOCK", [32, 3, 96, "None", "RE", 2]],
        [-1, 1, "InvertedBottleneck", [32, 3, 96, "None", "RE", 1]],
        [-1, 1, "MobileNetV3_BLOCK", [64, 5, 96, "None", "HS", 2]],
        [-1, 3, "InvertedBottleneck", [64, 5, 192, "None", "HS", 1]],
        [-1, 1, "MobileNetV3_BLOCK", [96, 5, 576, "None", "HS", 2]],
        [-1, 4, "InvertedBottleneck", [96, 5, 576, "None", "HS", 1]]]},
    # ShuffleNetV2 1.0x's layout (CBRM stem, units 4-8-4 cut to 1+1, 1+2, 1+1): 16, 64, 128, 256
    "shufflenetv2": {"p3": 2, "p4": 4, "rows": [
        [-1, 1, "CBRM", [32]], [-1, 1, "Shuffle_Block", [128, 2]], [-1, 3, "Shuffle_Block", [128, 1]],
        [-1, 1, "Shuffle_Block", [256, 2]], [-1, 7, "Shuffle_Block", [256, 1]],
        [-1, 1, "Shuffle_Block", [512, 2]], [-1, 3, "Shuffle_Block", [512, 1]]]},
    # EfficientNet-Lite0's 16 MBConvs (k, stride, expansion 1 or 6, no SE), at half width: 16, 8, 16, 24, 40, 56,
    # 96, 160; drop-connect 0, since the JAX package builds no graph with a rate above 0 (ROADMAP Queue 3)
    "efficientnet_lite": {"p3": 5, "p4": 11, "rows": [
        [-1, 1, "stem", [32]], [-1, 1, "MBConvBlock", [16, 3, 1, 1]],
        [-1, 1, "MBConvBlock", [24, 3, 2, 6]], [-1, 1, "MBConvBlock", [24, 3, 1, 6]],
        [-1, 1, "MBConvBlock", [40, 5, 2, 6]], [-1, 1, "MBConvBlock", [40, 5, 1, 6]],
        [-1, 1, "MBConvBlock", [80, 3, 2, 6]], [-1, 1, "MBConvBlock", [80, 3, 1, 6]],
        [-1, 1, "MBConvBlock", [80, 3, 1, 6]], [-1, 1, "MBConvBlock", [112, 5, 1, 6]],
        [-1, 1, "MBConvBlock", [112, 5, 1, 6]], [-1, 1, "MBConvBlock", [112, 5, 1, 6]],
        [-1, 1, "MBConvBlock", [192, 5, 2, 6]], [-1, 1, "MBConvBlock", [192, 5, 1, 6]],
        [-1, 1, "MBConvBlock", [192, 5, 1, 6]], [-1, 1, "MBConvBlock", [192, 5, 1, 6]],
        [-1, 1, "MBConvBlock", [320, 3, 1, 6]]]},
    # GhostNet 1.0x's 16 bottlenecks (mid widths as published, halved; SE where published): 8, 16, 24, 40 / 56, 80
    "ghostnet": {"p3": 5, "p4": 11, "rows": [
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "G_bneck", [16, 8, 3, 1]],
        [-1, 1, "G_bneck", [24, 24, 3, 2]], [-1, 1, "G_bneck", [24, 36, 3, 1]],
        [-1, 1, "G_bneck", [40, 36, 5, 2, True]], [-1, 1, "G_bneck", [40, 60, 5, 1, True]],
        [-1, 1, "G_bneck", [80, 120, 3, 2]], [-1, 1, "G_bneck", [80, 100, 3, 1]],
        [-1, 1, "G_bneck", [80, 92, 3, 1]], [-1, 1, "G_bneck", [80, 92, 3, 1]],
        [-1, 1, "G_bneck", [112, 240, 3, 1, True]], [-1, 1, "G_bneck", [112, 336, 3, 1, True]],
        [-1, 1, "G_bneck", [160, 336, 5, 2, True]], [-1, 1, "G_bneck", [160, 480, 5, 1]],
        [-1, 1, "G_bneck", [160, 480, 5, 1, True]], [-1, 1, "G_bneck", [160, 480, 5, 1]],
        [-1, 1, "G_bneck", [160, 480, 5, 1, True]]]},
    # MobileNeXt-1.0's sandglass stages (expansion 2 then 6; 96, 144, 192, 288, 384, 576, the last capped), halved:
    # 32, 48, 72, 96, 144, 192, 256
    "mobilenext": {"p3": 4, "p4": 7, "rows": [
        [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "SGBlock", [96, 2, 2]], [-1, 1, "SGBlock", [144, 1, 6]],
        [-1, 1, "SGBlock", [192, 2, 6]], [-1, 3, "SGBlock", [192, 1, 6]], [-1, 1, "SGBlock", [288, 2, 6]],
        [-1, 3, "SGBlock", [288, 1, 6]], [-1, 1, "SGBlock", [384, 1, 6]], [-1, 1, "SGBlock", [576, 2, 6]],
        [-1, 2, "SGBlock", [576, 1, 6]]]},
    # PP-LCNet 1.0x's depthwise-separable stages (3x3 then 5x5, SE in the last two), halved: 16, 32, 64, 128, 256
    "pplcnet": {"p3": 5, "p4": 7, "rows": [
        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "DepthSepConv", [64, 3, 1]], [-1, 1, "DepthSepConv", [128, 3, 2]],
        [-1, 1, "DepthSepConv", [128, 3, 1]], [-1, 1, "DepthSepConv", [256, 3, 2]],
        [-1, 1, "DepthSepConv", [256, 3, 1]], [-1, 1, "DepthSepConv", [512, 3, 2]],
        [-1, 5, "DepthSepConv", [512, 5, 1]], [-1, 1, "DepthSepConv", [1024, 5, 2, True]],
        [-1, 1, "DepthSepConv", [1024, 5, 1, True]]]},
}


def lpc_backbone_cfg(family: str) -> Dict[str, Any]:
    """The LPC-YOLO YAML (at its `s` scale) with its backbone (layers 0-14) replaced by one of the research zoo's
    families (`BACKBONE_VARIANTS`): the family's stages as published, then LPC-YOLO's SPPF and PSA. The neck and the
    v10Detect head stay: their reads of layers 7, 10 and 14 point at the family's stride-8 and stride-16 outputs and
    the PSA, every later index shifted by the change in the backbone's length. The widths at 640 (s scale), stride
    4 / 8 / 16 / 32: swin, convnext, starnet, fasternet 32 / 64 / 128 / 256; vanillanet 64 / 128 / 256 / 256;
    mobilenetv3 16 / 24 / 80 / 80 (the stride-16 read is 112's half, 56 -> 80 at its last stride-16 bneck); leyolo
    8 / 16 / 32 / 48; shufflenetv2 16 / 64 / 128 / 256; efficientnet_lite 16 / 24 / 56 / 160; ghostnet 8 / 24 / 56 /
    80; mobilenext 48 / 96 / 192 / 256; pplcnet 64 / 128 / 256 / 256. The SPPF and PSA after them are 256 wide."""
    if family not in BACKBONE_VARIANTS:
        raise ValueError(f"{family!r} is not one of the backbone variants {sorted(BACKBONE_VARIANTS)}")
    v = BACKBONE_VARIANTS[family]
    return lpc_cfg_with_backbone(v["rows"], v["p3"], v["p4"])


def lpc_cfg_with_backbone(rows, p3: int, p4: int) -> Dict[str, Any]:
    """The LPC-YOLO YAML with `rows`, then its SPPF and PSA, as the backbone: the neck reads rows[p3] (stride 8),
    rows[p4] (stride 16) and the PSA (stride 32) where it read layers 7, 10 and 14, every later index shifted."""
    d = _lpc_cfg()
    rows = [list(r) for r in rows] + [list(r) for r in _LPC_TAIL]
    new = {7: p3, 10: p4, 14: len(rows) - 1}
    shift = len(rows) - len(d["backbone"])

    def remap(j: int) -> int:
        return j if j < 0 else new[j] if j in new else j + shift

    d["backbone"] = rows
    d["head"] = [[remap(f) if isinstance(f, int) else [remap(j) for j in f], n, m, a] for f, n, m, a in d["head"]]
    return d


def write_lpc_backbone_yaml(family: str, directory: Union[str, Path]) -> Path:
    """`lpc_backbone_cfg(family)` written as `yolov10s-LPC-bb-<family>.yaml` under `directory`."""
    return _write_yaml(lpc_backbone_cfg(family), Path(directory) / f"yolov10s-LPC-bb-{family}.yaml")
