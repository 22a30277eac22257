"""The block set of LPC-YOLO, the YOLOv10 and YOLOv8 scales, the ResNet classifiers, the other CNN
detection YAMLs (v8 P2/P6 and ghost, v5, v3, v6), YOLOv9 (v9c, v9e) and RT-DETR's backbone and neck (HGStem,
HGBlock, LightConv, RepC3; its transformer parts are in `nn/transformer.py`) as torch nn.Modules (NCHW,
channels_last on the card).

Counterpart of `lpc_yolo_tpu/nn/modules.py`, plain semantics only: none of
the TPU layout rewrites (width packing, PackedBN, the C2f deploy algebra,
the s2d fold) are ported; int8 serving quantizes the plain graph
(`nn/quant.py`). Attribute names mirror the JAX module names
with numeric parts split off (`m_0` -> `m.0`, `ffn_1` -> `ffn.1`), so the
weight bridge (`utils/flax_bridge.py`) is a pure name map.

Activations follow the fork: blocks defined in its block.py (C2f, C2, C3,
C3Ghost, SPP, SPPF, PSA, LPC, Bottleneck, SCDown, CIB, C2fCIB, Proto,
ResNetBlock, the v9 blocks, HGStem, HGBlock, RepC3) use Mish, but for RepVGGDW's own SiLU and LightConv's ReLU; the conv.py family
(YAML-level `Conv`, `DWConv`, `GhostConv`, `RepConv` and the head towers) uses the
model's default activation, SiLU unless the YAML's `activation:` key says
`nn.ReLU()` (yolov6) or `nn.Mish()`. A ConvBN built with act "silu" (or
True) takes that default when it is built, from `DEFAULT_ACT`, as the JAX
`apply_act` resolves it (`lpc_yolo_tpu/nn/modules.py:214-222`), which
applies SiLU for `nn.Mish()` (ROADMAP Queue 3).
BatchNorm uses eps 1e-3 and momentum 0.03; in train mode its running
statistics follow the JAX package's (`BatchNorm2d` below).

Every `ConvBN` has two eval paths. Unfolded, it runs conv -> BN -> act in
plain PyTorch. After `fold()` (see `nn/fuse.py`) it runs on BN-folded
(W, b): a 3x3 stride-1 groups-1 conv goes through the hand-written kernel
(`ops/conv3x3.py`) with the activation fused, every other conv through
F.conv2d, as the JAX package left those to XLA. A `RepConv` folds its three
branches into one such conv. Train mode always runs unfolded, with autograd
through F.conv2d: no TPU kernel had a backward. In an int8 serving copy
(`nn/quant.py::quantize_serving`) a site's ConvBN runs through the s8 kernels
instead, and the C2f / C2fCIB and SPPF tails quantize their parts into one s8
buffer in place of the concat.
"""

from __future__ import annotations

import contextvars
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import apply_act, conv3x3

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
# the conv.py family's activation while a model is built: "silu", or the YAML's `activation:`
# ("relu" for nn.ReLU(), "mish" for nn.Mish())
DEFAULT_ACT = contextvars.ContextVar("lpc_torch_default_act", default="silu")


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same' symmetric padding (reference conv.py autopad)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train mode keeps the running statistics of the JAX
    package's BatchNorm (`lpc_yolo_tpu/nn/modules.py:199-206`): the running
    variance takes the biased batch variance (torch's takes the unbiased one,
    n/(n-1) larger), with momentum 0.03 on both, in the buffers' f32 whatever
    the input's dtype. Normalisation and its gradient are torch's own batch-norm op; eval
    mode and the state_dict are those of nn.BatchNorm2d.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            stat = self.running_var.dtype  # f32, whatever the input's dtype
            var = (invstd.to(stat) ** -2 - self.eps).clamp_(min=0)  # the biased batch variance
            self.running_mean.lerp_(mean.to(stat), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


class ConvBN(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d + activation (the reference `Conv`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, d: int = 1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = DEFAULT_ACT.get() if act in (True, "silu") else act
        self.folded = None  # (W, b) after fold(); W is HWIO on the kernel path; eval mode only
        self.q8 = None  # its int8 form (`nn/quant.py::Q8Conv`) in a quantized serving copy

    @property
    def kernel_path(self) -> bool:
        return is_kernel_path(self.conv)

    def train(self, mode: bool = True):
        if mode:
            self.folded = self.q8 = None  # a folded copy would go stale under training
        return super().train(mode)

    @torch.no_grad()
    def fold(self, dtype: torch.dtype, in_scale: float = 1.0) -> None:
        """Fold BN into the conv (W*f, b - mean*f), computed in f32, stored in `dtype`;
        `in_scale` also folds a scale of the input (x * in_scale) into W."""
        if self.training:
            raise RuntimeError("ConvBN.fold() is for eval mode: training needs the live BatchNorm")
        w, b = bn_folded(self.conv.weight, self.bn, self.conv.bias)
        self.folded = store_folded(w * in_scale if in_scale != 1.0 else w, b, dtype, self.kernel_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded is None:
            return apply_act(self.bn(self.conv(x)), self.act)
        if self.q8 is not None:
            return self.q8.run([x], self.act)
        return run_folded(x, self.folded, self.act, self.conv, self.kernel_path)


def is_kernel_path(c: nn.Conv2d) -> bool:
    """Whether a conv is a conv3x3 site once folded: 3x3, stride 1, groups 1, undilated."""
    return c.kernel_size == (3, 3) and c.stride == (1, 1) and c.groups == 1 and c.dilation == (1, 1)


def bn_folded(weight: torch.Tensor, bn: nn.BatchNorm2d, bias: Optional[torch.Tensor] = None):
    """A conv's weight, and its bias if it has one, with the eval-mode BN after it folded in, in f32:
    (W*f, beta + (b - mean)*f)."""
    f = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    mean = bn.running_mean.float() if bias is None else bn.running_mean.float() - bias.float()
    return weight.float() * f[:, None, None, None], bn.bias.float() - mean * f


def store_folded(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype, kernel_path: bool):
    """The folded (W, b) as `run_folded` takes them: on the kernel path W HWIO in `dtype` and b f32, as the
    conv3x3 kernel reads them; else both OIHW / (Co,) in `dtype` for F.conv2d."""
    if kernel_path:
        return w.permute(2, 3, 1, 0).contiguous().to(dtype), b.contiguous()
    return w.to(dtype), b.to(dtype)


def run_folded(x: torch.Tensor, folded, act, conv: nn.Conv2d, kernel_path: bool) -> torch.Tensor:
    """A folded conv + bias + act: through the conv3x3 kernel on the kernel path, else F.conv2d with `conv`'s
    geometry."""
    w, b = folded
    if kernel_path:
        xh = x.permute(0, 2, 3, 1)
        if xh.stride(3) != 1:  # not channel-contiguous: copy to channels_last (a C2f channel
            # slice of a channels_last map is channel-contiguous and passes as a strided view)
            xh = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return conv3x3(xh, w, b, act).permute(0, 3, 1, 2)
    y = F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups)
    return apply_act(y, act)


class BiasConv(nn.Conv2d):
    """A bare conv (a flax `nn.Conv` with its own `kernel` and, unless bias=False, `bias`; no activation) that folds
    as a ConvBN does: its weight and bias sit at the module's root, so the bridge's keys stay the JAX names
    (`conv_refine1/kernel` -> `conv_refine1.weight`), and once folded a 3x3 s1 g1 one is a conv3x3 site with the
    `none` epilogue (a zero bias where it has none). Where the JAX module follows it with a BatchNorm of its own
    (FasterNet's `proj` / `reduction` and `norm`), `post_bn` names that BatchNorm: the fold takes it in, and the
    owner skips it once folded (`folds_bn`)."""

    act = False

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 bias: bool = True):
        super().__init__(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=bias)
        self.folded = None
        self.post_bn = ()  # (the BatchNorm after it,) where the owner has one: a tuple, so it is not a child

    @property
    def kernel_path(self) -> bool:
        return is_kernel_path(self)

    def train(self, mode: bool = True):
        if mode:
            self.folded = None
        return super().train(mode)

    @torch.no_grad()
    def fold(self, dtype: torch.dtype, in_scale: float = 1.0) -> None:
        if self.training:
            raise RuntimeError("BiasConv.fold() is for eval mode")
        w, b = folded_weight_bias(self.weight, self.bias, self.post_bn)
        self.folded = store_folded(w * in_scale, b, dtype, self.kernel_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.folded is None:
            return super().forward(x)
        return run_folded(x, self.folded, False, self, self.kernel_path)


def folded_weight_bias(weight: torch.Tensor, bias: Optional[torch.Tensor], post_bn=()):
    """A conv's (W, b) in f32 for `store_folded`, a zero bias where it has none, the BatchNorm in `post_bn` (a tuple
    of one or none) folded in. The bias is a copy: an f32 bias's .float() is the Parameter itself, which a later
    .to(dtype) of the model rewrites."""
    if post_bn:
        return bn_folded(weight, post_bn[0], bias)
    b = bias.detach().float().clone() if bias is not None else torch.zeros(weight.shape[0], device=weight.device)
    return weight.float(), b


def folds_bn(conv: nn.Module) -> bool:
    """Whether `conv` (a BiasConv or a BN-free CBA with a `post_bn`) is folded with the BatchNorm after it, which
    its owner then skips."""
    return conv.folded is not None and bool(conv.post_bn)


class Bottleneck(nn.Module):
    """cv1 kxk -> cv2 kxk (+ residual) (reference block.py Bottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5,
                 act="mish"):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1, act=act)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g, act=act)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with two convs (reference block.py:214), plain path."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1, act="mish")
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1, act="mish")
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        for m in self.m:
            ys.append(m(ys[-1]))
        if self.cv2.q8 is not None:  # int8: the parts quantized into one s8 buffer, y in one launch for both halves
            return self.cv2.q8.run([y, *ys[2:]], self.cv2.act)
        return self.cv2(torch.cat(ys, 1))


class C3(nn.Module):
    """CSP bottleneck with three convs (JAX `nn/modules.py:987`; reference block.py:240): cv1 1x1 into n
    Bottlenecks with k=(1, 3), beside cv2 1x1, concatenated into cv3 1x1, Mish throughout."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv2 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv3 = ConvBN(2 * c_, c2, 1, act="mish")
        self.m = nn.Sequential(*(self.block(c_, shortcut, g) for _ in range(n)))

    @staticmethod
    def block(c: int, shortcut: bool, g: int) -> nn.Module:
        return Bottleneck(c, c, shortcut, g, k=(1, 3), e=1.0)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C2(nn.Module):
    """CSP bottleneck with two convs (JAX `nn/modules.py:1589`; reference block.py:194): cv1 1x1 to 2c, its first
    half through n 3x3 Bottlenecks, concatenated with the second half into cv2 1x1, Mish throughout."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1, act="mish")
        self.cv2 = ConvBN(2 * self.c, c2, 1, act="mish")
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)))

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([self.m(y[:, : self.c]), y[:, self.c:]], 1))


def DWConv(c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act="silu") -> ConvBN:
    """Depthwise conv (JAX `nn/modules.py:233`, built at `compiler.py:533-540`): a ConvBN with gcd(c1, c2)
    groups."""
    return ConvBN(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class GhostConv(nn.Module):
    """Ghost convolution (JAX `nn/modules.py:1024`; reference conv.py GhostConv): cv1 k x k stride s to c2 / 2,
    then a depthwise 5x5 cv2 of it, concatenated; conv.py's default activation unless `act` says otherwise."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act="silu"):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, act=act)
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (JAX `nn/modules.py:1636`; reference block.py:304): a GhostConv to c2 / 2, a depthwise
    k x k stride-2 conv when s = 2, a GhostConv to c2 with no activation, plus the input (at stride 2 through a
    depthwise and a 1x1 conv, both with no activation). The reference's nn.Sequential holds an Identity in the
    stride-1 slot, so the names are `conv.0`, `conv.2`, `shortcut.0`, `shortcut.1`, as in the JAX graph."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_, 1, 1),
                                  DWConv(c_, c_, k, 2, act=False) if s == 2 else nn.Identity(),
                                  GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, 2, act=False), ConvBN(c1, c2, 1, 1, act=False))
                         if s == 2 else nn.Identity())

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 with GhostBottlenecks (JAX `nn/modules.py:1665`; reference block.py:294)."""

    @staticmethod
    def block(c: int, shortcut: bool, g: int) -> nn.Module:
        return GhostBottleneck(c, c)


class SPP(nn.Module):
    """Spatial pyramid pooling with parallel stride-1 max-pools (JAX `nn/modules.py:1549`; reference block.py:139):
    cv1 1x1 to c1 / 2, its max-pools of each size in `k` concatenated after it, cv2 1x1, Mish."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv2 = ConvBN(c_ * (len(self.k) + 1), c2, 1, 1, act="mish")

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], 1))


class MaxPool2d(nn.Module):
    """nn.MaxPool2d(k, s, p) of a YAML (JAX `nn/modules.py:1910`): padding with -inf, as flax's max_pool pads."""

    def __init__(self, k: int, s: Optional[int] = None, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, k if s is None else s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """nn.ZeroPad2d([left, right, top, bottom]) of a YAML (JAX `nn/modules.py:1926`)."""

    def __init__(self, pads: Sequence[int]):
        super().__init__()
        self.pads = tuple(pads)

    def forward(self, x):
        return F.pad(x, self.pads)


class ConvTranspose(nn.Module):
    """A YAML's raw nn.ConvTranspose2d (JAX `ConvTransposeBN(use_bn=False, act=False)`, `nn/modules.py:1857`,
    built at `compiler.py:597-601`): a k x k stride-s transposed conv with a bias, no BN and no activation,
    under the JAX name `conv_transpose`. Its flax kernel (kh, kw, out, in) is the torch weight transposed, with
    no spatial flip, as Proto's."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, p, bias=True)

    def forward(self, x):
        return self.conv_transpose(x)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast (reference block.py:156): three chained maxpools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBN(c1, c_, 1, 1, act="mish")
        self.cv2 = ConvBN(4 * c_, c2, 1, 1, act="mish")

    def forward(self, x):
        x = self.cv1(x)
        pool = lambda t: F.max_pool2d(t, self.k, 1, self.k // 2)  # noqa: E731
        y1 = pool(x)
        y2 = pool(y1)
        if self.cv2.q8 is not None:  # int8: the four parts quantized with one scale into one s8 buffer
            return self.cv2.q8.run([x, y1, y2, pool(y2)], self.cv2.act)
        return self.cv2(torch.cat([x, y1, y2, pool(y2)], 1))


class SCDown(nn.Module):
    """Spatial-channel decoupled downsample (reference block.py:818): a 1x1 conv with Mish to c2,
    then a depthwise k x k stride-s conv with no activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1, act="mish")
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """Dual-branch depthwise conv (reference block.py:700): SiLU(dw7x7(x) + dw3x3(x)), both with
    BN and no activation of their own. The SiLU is the reference's own `nn.SiLU`, the only SiLU
    inside a block of this fork (every other block conv is the fork's Mish `Conv`).

    Folding keeps the two branches, each a BN-folded depthwise conv through F.conv2d, as the JAX
    package's `fuse_conv_bn` does; the 3x3 is not padded into the 7x7.
    """

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, p=3, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, p=1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block (reference block.py:735): depthwise 3x3, 1x1 to 2c_, a depthwise
    3x3 (RepVGGDW when `lk`), 1x1 to c2, depthwise 3x3, all with Mish (RepVGGDW: SiLU); the
    input is added when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1, act="mish"),
            ConvBN(c1, 2 * c_, 1, act="mish"),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_, act="mish"),
            ConvBN(2 * c_, c2, 1, act="mish"),
            ConvBN(c2, c2, 3, g=c2, act="mish"),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f with CIB bottlenecks (reference block.py:758): C2f's split and concat, plain path."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, e: float = 0.5):
        nn.Module.__init__(self)
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1, act="mish")
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1, act="mish")
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class Attention(nn.Module):
    """Spatial self-attention on a feature map (reference block.py:769).

    qkv's channels group per head as (kd, kd, hd) — the JAX module reshapes
    NHWC to (B, N, nh, 2*kd + hd) — and `pe` runs on v in head-major channel
    order, which the NCHW views below reproduce.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.nh = num_heads
        self.hd = dim // num_heads
        self.kd = int(self.hd * attn_ratio)
        self.scale = self.kd ** -0.5
        self.qkv = ConvBN(dim, dim + self.kd * num_heads * 2, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).reshape(B, self.nh, 2 * self.kd + self.hd, N)
        q, k, v = qkv.split([self.kd, self.kd, self.hd], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)  # (B, nh, N, N)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSA(nn.Module):
    """Partial self-attention (reference block.py:797)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1, act="mish")
        self.cv2 = ConvBN(2 * self.c, c2, 1, act="mish")
        self.attn = Attention(self.c, num_heads=max(self.c // 64, 1), attn_ratio=0.5)
        self.ffn = nn.Sequential(ConvBN(self.c, 2 * self.c, 1, act="mish"), ConvBN(2 * self.c, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class Proto(nn.Module):
    """YOLOv8 mask prototypes (reference block.py:64; JAX `nn/modules.py:1041-1056`): cv1 3x3 ConvBN,
    a 2x2 stride-2 transposed conv with bias (x2 the resolution), cv2 3x3 ConvBN, cv3 1x1 ConvBN to
    the c2 prototypes, Mish throughout. flax's ConvTranspose(transpose_kernel=True) kernel
    (kh, kw, out, in) is the torch weight (in, out, kh, kw) transposed, with no spatial flip."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = ConvBN(c1, c_, 3, act="mish")
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, bias=True)
        self.cv2 = ConvBN(c_, c_, 3, act="mish")
        self.cv3 = ConvBN(c_, c2, 1, act="mish")

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))



class ResNetBlock(nn.Module):
    """The bottleneck ResNet block of the JAX package (`nn/modules.py:1810-1826`; reference block.py:367):
    cv1 1x1 Mish, cv2 3x3 stride s Mish, cv3 1x1 to e*c2 with no act, plus the input (through a 1x1
    stride-s ConvBN, `shortcut.0`, when s != 1 or the channels differ), then ReLU of the sum. The
    stride-1 cv2 is a conv3x3 site once folded."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = ConvBN(c1, c2, 1, 1, act="mish")
        self.cv2 = ConvBN(c2, c2, 3, s, p=1, act="mish")
        self.cv3 = ConvBN(c2, c3, 1, act=False)
        self.shortcut = nn.Sequential(ConvBN(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3 else nn.Identity()

    def forward(self, x):
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """A ResNet stage (JAX `nn/modules.py:1829-1854`; reference block.py:382): with `is_first` a 7x7 stride-2
    ConvBN (Mish) and a 3x3 stride-2 max-pool with padding 1, else n `ResNetBlock`s, the first of stride s.
    The JAX pool pads with the dtype's finfo.min and F.max_pool2d with -inf: every 3x3 window holds a real
    pixel, so the two agree."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        self.is_first = is_first
        if is_first:
            self.layer = nn.Sequential(ConvBN(c1, c2, 7, 2, p=3, act="mish"))
        else:
            self.layer = nn.Sequential(*(ResNetBlock(c1 if i == 0 else e * c2, c2, s if i == 0 else 1, e)
                                         for i in range(n)))

    def forward(self, x):
        x = self.layer(x)
        return F.max_pool2d(x, 3, 2, 1) if self.is_first else x

class Upsample(nn.Module):
    """Nearest upsample by an integer factor (torch nn.Upsample(None, s, 'nearest'))."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    """Channel concat of routed inputs."""

    def forward(self, xs: Sequence[torch.Tensor]):
        return torch.cat(list(xs), 1)


class SpaceToDepth(nn.Module):
    """2x2 space-to-depth in the reference's order (block.py:4063):
    [(h0, w0), (h1, w0), (h0, w1), (h1, w1)]."""

    def forward(self, x):
        return torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1
        )


class SPCA(nn.Module):
    """Spatial-pyramid context attention (reference block.py:5725): three
    dilated depthwise 3x3 convs (d = 1, 2, 3) -> 1x1 merge, gated by an
    SE-style channel attention, plus the input. Raw convs, no BN."""

    def __init__(self, c: int):
        super().__init__()
        self.dilated_convs = nn.ModuleList(
            nn.Conv2d(c, c, 3, padding=d, dilation=d, groups=c, bias=False) for d in (1, 2, 3)
        )
        self.pointwise = nn.Conv2d(3 * c, c, 1, bias=True)
        self.attention = nn.Sequential(
            nn.Conv2d(c, c // 4, 1, bias=False), nn.ReLU(), nn.Conv2d(c // 4, c, 1, bias=False), nn.Sigmoid()
        )

    def forward(self, x):
        spatial = self.pointwise(torch.cat([conv(x) for conv in self.dilated_convs], 1))
        return spatial * self.attention(x.mean((2, 3), keepdim=True)) + x


def channel_shuffle2(x: torch.Tensor) -> torch.Tensor:
    """2-group shuffle: out[j] = in[2j] for the first half, in[2j+1] for the second."""
    B, C, H, W = x.shape
    return x.reshape(B, C // 2, 2, H, W).transpose(1, 2).reshape(B, C, H, W)


class LPC(nn.Module):
    """Light Perception Convolution (reference block.py:5801): half-channel
    conv -> 5x5 depthwise -> concat -> SPCA -> 2-group channel shuffle."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBN(c1, c_, k, s, g=g, act="mish")
        self.cv2 = ConvBN(c_, c_, 5, 1, g=c_, act="mish")
        self.spca = SPCA(2 * c_)

    def forward(self, x):
        x1 = self.cv1(x)
        return channel_shuffle2(self.spca(torch.cat([x1, self.cv2(x1)], 1)))


class ChannelAttention(nn.Module):
    """CBAM channel attention, conv.py variant: avg-pool -> 1x1 conv (bias) -> sigmoid gate."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """CBAM spatial attention: [mean, max] over channels -> kxk conv -> sigmoid gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, kernel_size, padding=3 if kernel_size == 7 else 1, bias=False)

    def forward(self, x):
        y = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv1(y))


class CBAM(nn.Module):
    """Convolutional block attention (reference conv.py CBAM; YAML arg = spatial kernel)."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


# -- the YOLOv9 set (JAX `nn/modules.py:946-971`, `:1060-1215`) --------------------------------------------------------


class RepConv(nn.Module):
    """Train-time multi-branch 3x3 conv (JAX `nn/modules.py:946-971`; reference conv.py RepConv): conv1 (3x3
    ConvBN) + conv2 (1x1 ConvBN), both with no activation, + an identity BatchNorm of the input (`bn`) when
    `use_identity` and c1 == c2 and s == 1, then conv.py's default activation.

    `fold()` merges the branches as the reference's `fuse_convs` does: each branch BN-folded, the 1x1 padded into
    the 3x3's centre tap, the identity BN added as a diagonal centre tap. At stride 1, groups 1 the result is one
    conv3x3 site with the activation as its epilogue (`kernel_path`), where the branches would be a 3x3 conv, a
    1x1 conv, an add and the activation. The JAX package serves the branches unfolded: the same function within
    f32 rounding. Train mode runs the branches, with autograd through F.conv2d.
    """

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act="silu", use_identity: bool = True):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepConv is a 3x3 conv, not {k}x{k}")
        self.conv1 = ConvBN(c1, c2, 3, s, p=1, g=g, act=False)
        self.conv2 = ConvBN(c1, c2, 1, s, p=0, g=g, act=False)
        self.bn = BatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM) if use_identity and c1 == c2 and s == 1 else None
        self.act = DEFAULT_ACT.get() if act in (True, "silu") else act
        self.folded = None  # (W, b) after fold(), as ConvBN keeps them; eval mode only
        self.q8 = None  # the int8 form of the folded conv (`nn/quant.py::Q8Conv`) in a quantized serving copy

    @property
    def kernel_path(self) -> bool:
        return self.conv1.kernel_path

    def train(self, mode: bool = True):
        if mode:
            self.folded = self.q8 = None
        return super().train(mode)

    @torch.no_grad()
    def fold(self, dtype: torch.dtype) -> None:
        """The three branches as one BN-folded 3x3 conv (computed in f32, stored in `dtype`)."""
        if self.training:
            raise RuntimeError("RepConv.fold() is for eval mode: training needs the live BatchNorms")
        w, b = bn_folded(self.conv1.conv.weight, self.conv1.bn)
        w1, b1 = bn_folded(self.conv2.conv.weight, self.conv2.bn)
        w[:, :, 1:2, 1:2] += w1
        b = b + b1
        if self.bn is not None:
            cin = w.shape[1]  # input channels a group
            ident = torch.zeros_like(w)
            ident[torch.arange(w.shape[0]), torch.arange(w.shape[0]) % cin, 1, 1] = 1.0
            wi, bi = bn_folded(ident, self.bn)
            w, b = w + wi, b + bi
        self.folded = store_folded(w, b, dtype, self.kernel_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.q8 is not None:
            return self.q8.run([x], self.act)
        if self.folded is not None:
            return run_folded(x, self.folded, self.act, self.conv1.conv, self.kernel_path)
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + self.bn(x)
        return apply_act(y, self.act)


class RepBottleneck(nn.Module):
    """RepConv 3x3 (no identity branch, SiLU) -> 3x3 ConvBN (block.py's Mish), + the input when `shortcut` and
    c1 == c2 (JAX `nn/modules.py:1060-1079`; reference block.py RepBottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, k[0], 1, use_identity=False)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g, act="mish")
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepCSP(C3):
    """C3 with RepBottlenecks (JAX `nn/modules.py:1082-1101`; reference block.py RepCSP): cv1, cv2, cv3 1x1 with
    Mish, `m.<i>`."""

    @staticmethod
    def block(c: int, shortcut: bool, g: int) -> nn.Module:
        return RepBottleneck(c, c, shortcut, g, e=1.0)


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN (JAX `nn/modules.py:1104-1126`; reference block.py RepNCSPELAN4): cv1 1x1 to c3, split in two
    halves; the upper half through cv2 = (RepCSP, 3x3 ConvBN), that through cv3 = (RepCSP, 3x3 ConvBN); the four
    concatenated into cv4 1x1; Mish throughout. The upper half is a channel view of cv1's map (no copy), which
    RepCSP's 1x1 convs read."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = ConvBN(c1, c3, 1, 1, act="mish")
        self.cv2 = nn.Sequential(RepCSP(c3 - self.c, c4, n), ConvBN(c4, c4, 3, 1, act="mish"))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), ConvBN(c4, c4, 3, 1, act="mish"))
        self.cv4 = ConvBN(c3 + 2 * c4, c2, 1, 1, act="mish")

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


class ADown(nn.Module):
    """v9 downsample (JAX `nn/modules.py:1129-1146`; reference block.py ADown): a 2x2 stride-1 average pool (H ->
    H - 1), split in channel halves; the first through a 3x3 stride-2 ConvBN (F.conv2d, not a conv3x3 site), the
    second through a 3x3 stride-2 max-pool (padding -inf, as flax pads) and a 1x1 ConvBN; concatenated, Mish.
    Both branches land on ceil((H - 1) / 2) rows, odd H - 1 included."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBN(c1 // 2, self.c, 3, 2, p=1, act="mish")
        self.cv2 = ConvBN(c1 - c1 // 2, self.c, 1, 1, p=0, act="mish")

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 1, 0)
        h = x.shape[1] // 2
        return torch.cat([self.cv1(x[:, :h]), self.cv2(F.max_pool2d(x[:, h:], 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """SPP-ELAN (JAX `nn/modules.py:1149-1165`; reference block.py SPPELAN): cv1 1x1 to c3, three chained k x k
    stride-1 max-pools, the four concatenated into cv5 1x1; Mish."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.k = k
        self.cv1 = ConvBN(c1, c3, 1, 1, act="mish")
        self.cv5 = ConvBN(4 * c3, c2, 1, 1, act="mish")

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv5(torch.cat(y, 1))


class Silence(nn.Module):
    """The identity (JAX `nn/modules.py:1168-1173`): yolov9e's layer 0, through which two layers read the frame."""

    def forward(self, x):
        return x


class CBLinear(nn.Module):
    """A biased k x k conv with no BN and no activation, its output split into a tuple of maps of the widths
    `c2s` (JAX `nn/modules.py:1176-1197`; reference block.py CBLinear). The maps are channel views of one
    output."""

    def __init__(self, c1: int, c2s: Sequence[int], k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = nn.Conv2d(c1, sum(self.c2s), k, s, autopad(k), bias=True)

    def forward(self, x):
        return self.conv(x).split(self.c2s, 1)


class CBFuse(nn.Module):
    """The last input plus, for each earlier input i (a CBLinear tuple), its map `idx[i]` resized to the last
    input's H x W, summed in the JAX order (JAX `nn/modules.py:1200-1215`; reference block.py CBFuse). The resize
    is `jax.image.resize(..., "nearest")`, which is torch's "nearest-exact" at every ratio ("nearest" differs at
    a non-integer one)."""

    def __init__(self, idx: Sequence[int]):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs: Sequence):
        total = xs[-1]
        for i, x in enumerate(xs[:-1]):
            total = total + F.interpolate(x[self.idx[i]], size=total.shape[2:], mode="nearest-exact")
        return total


# -- the RT-DETR set (JAX `nn/modules.py:1717-1807`) --------------------------------------------------------------------


class RepC3(nn.Module):
    """RT-DETR's neck CSP block (JAX `nn/modules.py:1717-1735`; reference block.py RepC3): cv1 1x1 (Mish) into n
    RepConvs with no identity branch (conv.py's SiLU), plus cv2 1x1 (Mish) of the input, and cv3 1x1 (Mish) of
    the sum when c_ = e * c2 differs from c2. Each RepConv folds into one conv3x3 site."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c2, 1, 1, act="mish")
        self.m = nn.Sequential(*(RepConv(c2 if i == 0 else c_, c_, use_identity=False) for i in range(n)))
        self.cv2 = ConvBN(c1, c2, 1, 1, act="mish")
        self.cv3 = ConvBN(c_, c2, 1, 1, act="mish") if c_ != c2 else None

    def forward(self, x):
        y = self.m(self.cv1(x)) + self.cv2(x)
        return y if self.cv3 is None else self.cv3(y)


class LightConv(nn.Module):
    """A 1x1 ConvBN with no activation, then a depthwise k x k ConvBN with `act` (JAX `nn/modules.py:1738-1749`;
    reference conv.py LightConv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, act="relu"):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 1, act=False)
        self.conv2 = ConvBN(c2, c2, k, g=c2, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class HGStem(nn.Module):
    """PPHGNetV2's stem (JAX `nn/modules.py:1752-1778`; reference block.py HGStem), Mish throughout: stem1 3x3 s2,
    a zero pad of one column and one row on the right and bottom; one branch stem2a 2x2 (same pad) stem2b 2x2,
    the other a 2x2 stride-1 max-pool of the padded map; concatenated into stem3 3x3 s2 and stem4 1x1. stem1 reads
    the frame, so it takes the /255 fold (`nn/fuse.py::fold_preprocess`)."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBN(c1, cm, 3, 2, act="mish")
        self.stem2a = ConvBN(cm, cm // 2, 2, 1, p=0, act="mish")
        self.stem2b = ConvBN(cm // 2, cm, 2, 1, p=0, act="mish")
        self.stem3 = ConvBN(cm * 2, cm, 3, 2, act="mish")
        self.stem4 = ConvBN(cm, c2, 1, 1, act="mish")

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        return self.stem4(self.stem3(torch.cat([F.max_pool2d(x, 2, 1), x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2's block (JAX `nn/modules.py:1781-1807`; reference block.py HGBlock): n chained k x k ConvBNs (Mish;
    at k = 3 each is a conv3x3 site) or LightConvs, the input and every one of their outputs concatenated into sc
    1x1 to c2 / 2 and ec 1x1 to c2 (Mish), plus the input when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False,
                 shortcut: bool = False):
        super().__init__()
        self.m = nn.ModuleList(LightConv(c1 if i == 0 else cm, cm, k) if lightconv
                               else ConvBN(c1 if i == 0 else cm, cm, k, act="mish") for i in range(n))
        self.sc = ConvBN(c1 + n * cm, c2 // 2, 1, 1, act="mish")
        self.ec = ConvBN(c2 // 2, c2, 1, 1, act="mish")
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        if self.sc.q8 is not None:  # int8: the parts quantized into one s8 buffer, as C2f's tail
            y = self.ec(self.sc.q8.run(ys, self.sc.act))
        else:
            y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


# -- the YOLO-World set (JAX `nn/modules.py:1218-1371`) -----------------------------------------------------------------


class MaxSigmoidAttnBlock(nn.Module):
    """Max-sigmoid text-guided attention (JAX `nn/modules.py:1219-1249`; reference block.py:404-437). The map's
    embedding (`ec`, a 1x1 ConvBN with no activation, only when c1 != ec) is split into nh heads of hc = c2 // nh
    channels; each head's dot with every text row (`gl`, a Linear from gc to ec) is maxed over the M rows, divided
    by sqrt(hc), offset by the head's `bias` and put through a sigmoid: one weight a head and pixel, which scales
    that head's channels of `proj_conv` (a 3x3 ConvBN with no activation: a conv3x3 site with the `none`
    epilogue once folded). The attention runs in f32 when the map is bf16. The JAX block's optional learned
    `scale` is never built by the compiler and is not ported."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.nh, self.hc = nh, c2 // nh
        self.ec = ConvBN(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = ConvBN(c1, c2, 3, 1, act=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        embed = x if self.ec is None else self.ec(x)
        g = self.gl(guide.to(self.gl.weight.dtype))
        dt = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast("cuda", enabled=False):  # the training forward runs under bf16 autocast
            e = embed.to(dt).view(B, self.nh, self.hc, H, W)
            aw = torch.einsum("bmchw,bnmc->bmhwn", e, g.to(dt).view(B, -1, self.nh, self.hc))
            aw = (aw.amax(-1) / self.hc ** 0.5 + self.bias.to(dt)[:, None, None]).sigmoid()  # (B, nh, H, W)
        y = self.proj_conv(x)
        return (y.view(B, self.nh, self.hc, H, W) * aw[:, :, None].to(y.dtype)).view(B, -1, H, W)


class C2fAttn(nn.Module):
    """The fork's C2f with a text-guided attention branch (JAX `nn/modules.py:1252-1283`; reference block.py:439-465):
    cv1 1x1 (Mish) to 2c, n 3x3 / 3x3 Bottlenecks (Mish) on the last half, then `attn` (MaxSigmoidAttnBlock) on the
    last map, all concatenated into cv2 1x1 (Mish)."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1, act="mish")
        self.cv2 = ConvBN((3 + n) * self.c, c2, 1, act="mish")
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, nh=nh, ec=ec, gc=gc)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        if self.cv2.q8 is not None:  # int8: as C2f's tail, the attention's output one part more
            return self.cv2.q8.run([y, *ys[2:]], self.cv2.act)
        return self.cv2(torch.cat(ys, 1))


class ImagePoolingAttn(nn.Module):
    """Image-aware text enhancement (JAX `nn/modules.py:1286-1336`; reference block.py:468-511): each level through
    its 1x1 biased conv (`projections`) to ec channels and a k x k adaptive max-pool (torch's windows
    [floor(j H / k), ceil((j + 1) H / k)), the ones the JAX code builds), the nf * k * k patches as keys and values
    (LayerNorm, Linear), the text as queries (LayerNorm, Linear), nh-head softmax attention, `proj` back to ct, plus
    the text: (B, M, ct). The LayerNorms take flax's epsilon 1e-6. The JAX block's optional learned `scale` is
    never built by the compiler and is not ported."""

    def __init__(self, ec: int = 256, ch: Sequence[int] = (), ct: int = 512, nh: int = 8, k: int = 3):
        super().__init__()
        self.nh, self.k = nh, k
        self.projections = nn.ModuleList(nn.Conv2d(c, ec, 1) for c in ch)
        self.query_ln, self.query_fc = nn.LayerNorm(ct, eps=1e-6), nn.Linear(ct, ec)
        self.key_ln, self.key_fc = nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec)
        self.value_ln, self.value_fc = nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec)
        self.proj = nn.Linear(ec, ct)

    def forward(self, xs: Sequence[torch.Tensor], text: torch.Tensor) -> torch.Tensor:
        B, M = text.shape[:2]
        p = torch.cat([F.adaptive_max_pool2d(proj(x), self.k).flatten(2) for proj, x in zip(self.projections, xs)],
                      2).transpose(1, 2)  # (B, nf * k * k, ec)
        text = text.to(self.query_fc.weight.dtype)
        heads = lambda t: t.reshape(B, t.shape[1], self.nh, -1).transpose(1, 2)  # noqa: E731  (B, nh, L, hc)
        q = heads(self.query_fc(self.query_ln(text)))
        kk = heads(self.key_fc(self.key_ln(p)))
        v = heads(self.value_fc(self.value_ln(p)))
        out = F.scaled_dot_product_attention(q, kk, v).transpose(1, 2).reshape(B, M, -1)
        return self.proj(out) + text


class ContrastiveHead(nn.Module):
    """Region-text similarity logits (JAX `nn/modules.py:1339-1353`; reference block.py:514-531): the embedding map
    x (B, C, H, W) and the text w (B, M, C), each divided by max(its L2 norm, 1e-12) (`F.normalize`), their cosines
    (B, M, H, W) times exp(`logit_scale`) (init log(1 / 0.07)) plus the scalar `bias`, in f32 when the inputs are
    bf16 (the scale is ~14 at init). `keeps_f32`: a serving copy in another dtype keeps this module's parameters
    and buffers in f32."""

    keeps_f32 = True

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(()))
        self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07)))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return F.normalize(x, dim=1, eps=1e-12)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast("cuda", enabled=False):  # the training forward runs under bf16 autocast
            x, w = self.embed(x.to(dt)), F.normalize(w.to(dt), dim=-1, eps=1e-12)
            return torch.einsum("bchw,bmc->bmhw", x, w) * self.logit_scale.to(dt).exp() + self.bias.to(dt)


class BNContrastiveHead(ContrastiveHead):
    """The BatchNorm variant (JAX `nn/modules.py:1356-1371`; reference block.py:534-556): the embedding through a
    BatchNorm (`norm`, eps 1e-3, the JAX running statistics) in place of its normalisation, only the text
    normalised; `logit_scale` starts at -1.0. In f32 as ContrastiveHead."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.norm = BatchNorm2d(embed_dims, eps=BN_EPS, momentum=BN_MOMENTUM)
        nn.init.constant_(self.logit_scale, -1.0)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)
