"""3x3 stride-1 conv with a fused bias + activation epilogue (NHWC, HWIO).

Replaces the TPU kernel `lpc_yolo_tpu/ops/pallas_conv.py::conv3x3_pallas`
(`_conv3_kernel`). On the serving path every BN-folded 3x3 s1 g1 conv of
every ported graph runs through it: for LPC-YOLO the stride-1 stage convs,
every C2f bottleneck and the v10Detect box towers; for the other YAMLs also
the C2 / C3 bottlenecks, the plain 3x3 s1 `Conv` layers (v3, v6) and the
head towers. The epilogue applies the activation the model resolved, ReLU
included (yolov6's `activation: nn.ReLU()`), as the TPU kernel's
`apply_act(acc, act)` does. The CUDA source (`csrc/conv3x3.cu`) says what bounds
it on the H100 and how its tiling answers that.

The public layout is the JAX package's: x (B, H, W, C) NHWC, w (3, 3, C, Co)
HWIO, b (Co,). A channels_last NCHW tensor permuted to NHWC is a view, and the
kernel takes any batch/row/pixel strides as long as channels are contiguous,
so a channel slice of a C2f split reaches it without a copy.

The bf16 kernel is a template with a handful of instantiations (`CONFIGS`);
`conv3x3_config` picks one per shape in Python, and the wrapper passes its
index to the C entry point.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

ACTS = {False: 0, "silu": 1, "mish": 2, "relu": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448  # dynamic shared memory one block may use on an H100
MIN_BLOCKS = 132  # one block per SM: a tiling that gives fewer gives way to a smaller tile

# (tile_h, tile_w, bn, ck, stages, wm, wn) of each bf16 instantiation, in the order of
# kConfigs in csrc/conv3x3.cu: pixel tile, output channels per block, input channels per
# chunk, ring depth, and the pixels x channels each warp computes.
CONFIGS: Tuple[Tuple[int, ...], ...] = (
    (16, 16, 16, 16, 2, 32, 16),  # 16x16 pixels, 16-channel chunks
    (16, 16, 32, 16, 2, 32, 32),
    (16, 16, 64, 16, 3, 64, 32),
    (16, 16, 128, 16, 3, 64, 32),
    (8, 16, 64, 32, 2, 32, 32),  # 40^2 maps, Co <= 64
    (4, 24, 64, 32, 2, 32, 32),  # 20^2 maps, Co <= 64
    (8, 40, 128, 32, 2, 80, 32),  # 80^2 and 40^2 maps, Co > 64
    (4, 24, 128, 16, 2, 32, 32),  # 20^2 maps, Co > 64
)
# The instantiations for each channel tile, in order of preference (the largest pixel tile first).
TILINGS = {16: (0,), 32: (1,), 64: (2, 4, 5), 128: (6, 3, 7)}


class Conv3x3Config(NamedTuple):
    """One bf16 instantiation and the launch it gives for a shape."""
    index: int
    tile_h: int
    tile_w: int
    bn: int
    ck: int
    stages: int
    wm: int
    wn: int
    threads: int
    smem: int  # dynamic shared memory bytes
    grid: Tuple[int, int]  # (pixel tiles x batch, output-channel tiles)


def _describe(index: int, B: int, H: int, W: int, Co: int) -> Conv3x3Config:
    th, tw, bn, ck, stages, wm, wn = CONFIGS[index]
    threads = 32 * (th * tw // wm) * (bn // wn)
    ring = stages * ((th + 2) * (tw + 2) * (ck + 8) + 9 * ck * (bn + 8)) * 2
    smem = max(ring, th * tw * (bn + 8) * 2)  # the ring, or the bf16 output tile of the epilogue
    grid = (B * -(-H // th) * -(-W // tw), -(-Co // bn))
    return Conv3x3Config(index, th, tw, bn, ck, stages, wm, wn, threads, smem, grid)


def _waste(H: int, W: int, th: int, tw: int) -> float:
    """Share of the pixels a tiling computes that lie outside the H x W map."""
    return 1.0 - H * W / (-(-H // th) * th * -(-W // tw) * tw)


@functools.lru_cache(maxsize=None)
def conv3x3_config(B: int, H: int, W: int, C: int, Co: int) -> Conv3x3Config:
    """The bf16 instantiation for a (B, H, W, C) -> Co conv, and its launch.

    The channel tile is the smallest that covers Co (at most 128, so Co = 256
    takes two). Of its instantiations whose channel chunk divides C (else those
    with 16-channel chunks), the first whose pixel tile wastes under a quarter of
    the pixels it computes and gives at least one block per SM, else the last.
    """
    bn = next((n for n in (16, 32, 64, 128) if n >= Co), 128)
    cands = [i for i in TILINGS[bn] if C % CONFIGS[i][3] == 0] or [i for i in TILINGS[bn] if CONFIGS[i][3] == 16]
    for index in cands:
        cfg = _describe(index, B, H, W, Co)
        if _waste(H, W, cfg.tile_h, cfg.tile_w) < 0.25 and cfg.grid[0] * cfg.grid[1] >= MIN_BLOCKS:
            break
    return cfg


def apply_act(x: torch.Tensor, act) -> torch.Tensor:
    """none / SiLU / Mish / ReLU, with softplus as jax.nn.softplus computes it."""
    code = ACTS[act]
    if code == 1:
        return F.silu(x)
    if code == 2:
        sp = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        return x * torch.tanh(sp)
    if code == 3:
        return F.relu(x)
    return x


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, act=False) -> torch.Tensor:
    """Plain PyTorch version: the same function through F.conv2d, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 None if b is None else b.to(x.dtype), padding=1)
    return apply_act(y, act).permute(0, 2, 3, 1)


# conv3x3_launch(x, w, bias, y, B, H, W, C, Co, sxb, sxh, sxw, act, dtype, config, stream)
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
_entry = None  # the C entry point, bound once
_zero_bias: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _launch_fn():
    global _entry
    if _entry is None:
        fn = _build.load("conv3x3").conv3x3_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, act=False, *,
            config: Optional[int] = None) -> torch.Tensor:
    """Same-padded 3x3 stride-1 conv + bias + act: (B, H, W, C) -> (B, H, W, Co).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. The output is a contiguous NHWC tensor (a channels_last NCHW
    tensor after `.permute(0, 3, 1, 2)`). `config` forces a bf16
    instantiation (an index into CONFIGS; every one computes the same
    function) in place of `conv3x3_config`'s choice, for timing them.
    """
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"shapes do not fit a 3x3 conv: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, act)
    B, H, W, C = x.shape
    Co = w.shape[3]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3 takes f32 or bf16 x and w of one dtype, got {x.dtype} and {w.dtype}")
    if x.stride(3) != 1 or not w.is_contiguous():
        raise ValueError("conv3x3 needs channel-contiguous x (NHWC) and contiguous HWIO w")
    if b is None:
        bias = _zero_bias.get((Co, x.device))
        if bias is None:
            bias = _zero_bias[(Co, x.device)] = torch.zeros(Co, dtype=torch.float32, device=x.device)
    else:
        bias = b
    if bias.dtype != torch.float32 or bias.shape != (Co,) or not bias.is_contiguous() or bias.device != x.device:
        raise ValueError("bias must be a contiguous f32 (Co,) tensor on x's device")
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    if config is None:
        config = conv3x3_config(B, H, W, C, Co).index if x.dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _launch_fn()(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), B, H, W, C, Co,
                      x.stride(0), x.stride(1), x.stride(2), ACTS[act], DTYPES[x.dtype], config, stream)
    _build.check(rc, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
