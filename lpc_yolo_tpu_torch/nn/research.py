"""The research zoo's attention family as torch nn.Modules (counterpart of `lpc_yolo_tpu/nn/research.py:49-734`).

The 21 attention modules that the JAX YAML compiler reaches through `build_research_module` (:2050-2068), with
the helpers they use, in NCHW. Attribute and parameter names mirror the JAX ones, numeric parts split off
(`conv_0` -> `conv.0`), so the weight bridge stays a name map; a bare JAX parameter (ECA's `conv`,
ShuffleAttention's `cweight` ..., SpatialGroupEnhance's `weight` and `bias`, CrissCrossAttention's `gamma`, MHSA's
`rel_h` / `rel_w`) is a Parameter of the same name and JAX layout. SKAttention's `fc` (channel -> d) is a Linear
whose children "0".."3" are the branch Linears `fc_0`..`fc_3`: torch keeps `fc.weight` beside `fc.0.weight` that
way, with no renamed key. NAMAttention's BatchNorm leaves sit at its root, so it is a `BatchNorm2d` itself.

Every conv+BN unit is a `CBA`, a `ConvBN` (`nn/modules.py`), so `nn/fuse.py` folds it for serving, a conv bias
included (`b' = beta + (b_conv - mean) * gamma / sigma`, which the JAX `fuse_conv_bn` drops), and a 3x3 s1 g1 one
runs the conv3x3 kernel: SKAttention's `conv_1` (ReLU) and ParNetAttention's `conv3x3` (no activation, a conv
bias). Everything else runs in plain PyTorch, as the JAX package left it to XLA.

Divergences copied from the JAX package by design: flax's `nn.gelu` is the tanh form; SpatialGroupEnhance's
std is the biased one; CoTAttention's 9 * dim `attn2` channels are read k*k-major; the LayerNorms and the
GroupNorm take flax's eps 1e-6. Not copied: the JAX ShuffleAttention splits the map into blocks of rows where
SA-Net (Zhang & Yang, 2021) splits the channels into groups; the port runs the published channel-group forward.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import apply_act
from .modules import BN_EPS, BN_MOMENTUM, BatchNorm2d, ConvBN, autopad, store_folded

LN_EPS = 1e-6  # flax LayerNorm's and GroupNorm's default epsilon
LPC_YAML = Path(__file__).resolve().parents[1] / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
LPC_ATTENTION_LAYER = 21  # LPC-YOLO's CBAM [7], on the 80² map at 64 channels at 640

# -- the parse rules of the attention family (JAX research.py:2012-2040) --------------------------------------------
# args[0] a width-scaled output-channel count: out_args = [c1, c2, *rest]
WIDTH_SCALED = {"CoordAtt", "GAMAttention"}
# out_args = [c1, *yaml_args]; output channels unchanged
C1_PREPEND = {"SE", "ECA", "ShuffleAttention", "SKAttention", "DoubleAttention", "CoTAttention",
              "EffectiveSEModule", "GlobalContext", "GatherExcite", "MHSA"}
# out_args = [c1] only
C1_ONLY = {"S2Attention", "NAMAttention", "CrissCrossAttention", "SequentialPolarizedSelfAttention",
           "ParallelPolarizedSelfAttention", "ParNetAttention"}
# args pass through untouched; output channels unchanged
PASSTHROUGH = {"SimAM", "SpatialGroupEnhance", "TripletAttention"}
ATTENTION = WIDTH_SCALED | C1_PREPEND | C1_ONLY | PASSTHROUGH


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


# the CBA activations that are a conv3x3 epilogue, by the kernel's names
_EPILOGUE = {"none": False, "identity": False, "relu": "relu", "silu": "silu", "mish": "mish"}


class CBA(ConvBN):
    """Conv2d + optional BatchNorm + activation, the zoo's generic conv unit (JAX :75-118): a `ConvBN` with an
    optional conv bias and BN and the zoo's activation names ("silu" is SiLU here, never the YAML's default).
    Folded, its conv bias goes into the bias; without BN the fold is the conv itself."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: str = "relu", bn: bool = True, bias: bool = False):
        super().__init__(c1, c2, k, s, p=p, g=g, d=d, act=False)
        if act not in _EPILOGUE:
            raise NotImplementedError(f"CBA with activation {act!r} is not ported (the port takes {sorted(_EPILOGUE)})")
        if bias:
            self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=True)
        if not bn:
            self.bn = None
        self.act = _EPILOGUE[act]

    @torch.no_grad()
    def fold(self, dtype: torch.dtype, in_scale: float = 1.0) -> None:
        if self.bn is not None:
            return super().fold(dtype, in_scale)
        if self.training:
            raise RuntimeError("CBA.fold() is for eval mode")
        w = self.conv.weight.float() * in_scale
        b = self.conv.bias.float() if self.conv.bias is not None else torch.zeros_like(w[:, 0, 0, 0])
        self.folded = store_folded(w, b, dtype, self.kernel_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded is None and self.bn is None:
            return apply_act(self.conv(x), self.act)
        return super().forward(x)


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


def build_research_module(m: str, a: tuple) -> nn.Module:
    """One attention module from its compiled (name, args), as the JAX `build_research_module` (:2050-2068)."""
    if m not in ATTENTION:
        raise NotImplementedError(f"research module '{m}' is not ported to torch yet")
    if m == "SKAttention" and len(a) > 1:
        a = (a[0], tuple(a[1]), *a[2:])
    return globals()[m](*a)


def lpc_attention_cfg(module: str) -> Dict[str, Any]:
    """The LPC-YOLO YAML (at its `s` scale) with layer 21's `CBAM [7]` replaced by an attention module: args
    `[128]` (64 at the 0.5 width) for the width-scaled CoordAtt and GAMAttention, `[]` for the others; no index
    moves."""
    import yaml

    if module not in ATTENTION:
        raise ValueError(f"{module!r} is not one of the zoo's attention modules")
    d = yaml.safe_load(LPC_YAML.read_text())
    layer = d["head"][LPC_ATTENTION_LAYER - len(d["backbone"])]
    assert layer[2] == "CBAM", layer
    d["head"][LPC_ATTENTION_LAYER - len(d["backbone"])] = [-1, 1, module, [128] if module in WIDTH_SCALED else []]
    return d


def write_lpc_attention_yaml(module: str, directory: Union[str, Path]) -> Path:
    """`lpc_attention_cfg(module)` written as `yolov10s-LPC-<module>.yaml` under `directory` (the scale letter in
    the name, as the facade reads it)."""
    import yaml

    path = Path(directory) / f"yolov10s-LPC-{module}.yaml"
    path.write_text(yaml.safe_dump(lpc_attention_cfg(module), sort_keys=False))
    return path
