"""s8 x s8 -> s32 convolution with a dequantize + bias + activation epilogue (NHWC).

Replaces no TPU kernel: the JAX package runs its int8 serving convs as XLA's `lax.conv_general_dilated`
over s8 operands with `preferred_element_type=int32`, then dequantizes (`lpc_yolo_tpu/nn/quant.py:135-139`,
`:186-189`, `:244-248`), and PyTorch has no int8 convolution on CUDA. The kernel (`csrc/conv_s8.cu`) is an
implicit GEMM on the int8 tensor cores for every int8 site of the serving graphs (`nn/quant.py`): 1x1 and
3x3, stride 1 or 2, same padding, groups 1. It computes

    y = act(f32(acc) * (sx * sw[c]) + b[c]),  acc = the exact s32 sum of x8 * w8,

in f32 and stores y in bf16 or f32. The JAX package rounds the dequantized sum to the serving dtype before
it adds the bias; in f32 the two are the same function, in bf16 they part by a rounding.

Layouts: x8 (B, H, W, C) NHWC with channels contiguous and any batch/row/pixel strides; w8 (Co, kh, kw, C),
each output channel's K values contiguous (the layout of an mma B fragment, see the source); sw and b
(Co,) f32; the output is a contiguous NHWC tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3 import ACTS, apply_act

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv_s8_plain(x8: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, sx: float, b: Optional[torch.Tensor] = None,
                  act=False, stride: int = 1, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version. The s32 sums are exact: an f64 conv of the integer values (every product and
    partial sum is an integer far below 2^53; an f32 conv is not exact once 9 * C * 127^2 > 2^24)."""
    k = w8.shape[1]
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(), w8.permute(0, 3, 1, 2).double(), stride=stride, padding=k // 2)
    scale = sw.float() * torch.tensor(sx, dtype=torch.float32, device=sw.device)
    y = acc.float() * scale[:, None, None]
    if b is not None:
        y = y + b.float()[:, None, None]
    return apply_act(y, act).to(out_dtype).permute(0, 2, 3, 1)


# conv_s8_launch(x, w, sw, sx, bias, y, B, H, W, C, Co, k, stride, sxb, sxh, sxw, act, out_dtype, stream)
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_entry = None
_zero_bias: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _launch_fn():
    global _entry
    if _entry is None:
        fn = _build.load("conv_s8").conv_s8_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def check_geometry(k: int, stride: int) -> None:
    """Raise unless the kernel takes a k x k stride `stride` conv (same padding, groups 1 assumed)."""
    if k not in (1, 3) or stride not in (1, 2):
        raise NotImplementedError(f"conv_s8 takes 1x1 and 3x3 convs at stride 1 or 2, not {k}x{k} stride {stride}")


def conv_s8(x8: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, sx: float, b: Optional[torch.Tensor] = None,
            act=False, stride: int = 1, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Same-padded k x k (k 1 or 3) stride 1 or 2 s8 conv + dequantize + bias + act:
    (B, H, W, C) s8 -> (B, Ho, Wo, Co) in `out_dtype`.

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise. `sx` is the activation
    scale (the kernel takes its f32), `sw` the per-output-channel weight scales.
    """
    if x8.dim() != 4 or w8.dim() != 4 or w8.shape[3] != x8.shape[3] or w8.shape[1] != w8.shape[2]:
        raise ValueError(f"shapes do not fit a conv: x8 {tuple(x8.shape)}, w8 (Co, k, k, C) {tuple(w8.shape)}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise ValueError(f"conv_s8 takes s8 x and w, got {x8.dtype} and {w8.dtype}")
    if act not in ACTS or out_dtype not in OUT_DTYPES:
        raise ValueError(f"unsupported activation {act!r} or output dtype {out_dtype}")
    k = w8.shape[1]
    check_geometry(k, stride)
    if x8.device.type == "cpu":
        return conv_s8_plain(x8, w8, sw, sx, b, act, stride, out_dtype)
    B, H, W, C = x8.shape
    Co = w8.shape[0]
    if x8.device.type != "cuda" or w8.device != x8.device or sw.device != x8.device:
        raise ValueError("x8, w8 and sw must lie on the same CUDA device")
    if x8.stride(3) != 1 or not w8.is_contiguous():
        raise ValueError("conv_s8 needs channel-contiguous x8 (NHWC) and contiguous (Co, k, k, C) w8")
    if b is None:
        b = _zero_bias.get((Co, x8.device))
        if b is None:
            b = _zero_bias[(Co, x8.device)] = torch.zeros(Co, dtype=torch.float32, device=x8.device)
    for name, t in (("sw", sw), ("bias", b)):
        if t.dtype != torch.float32 or t.shape != (Co,) or not t.is_contiguous() or t.device != x8.device:
            raise ValueError(f"{name} must be a contiguous f32 (Co,) tensor on x8's device")
    p = k // 2
    Ho, Wo = (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1
    out = torch.empty((B, Ho, Wo, Co), dtype=out_dtype, device=x8.device)
    rc = _launch_fn()(x8.data_ptr(), w8.data_ptr(), sw.data_ptr(), float(sx), b.data_ptr(), out.data_ptr(), B, H, W,
                      C, Co, k, stride, x8.stride(0), x8.stride(1), x8.stride(2), ACTS[act], OUT_DTYPES[out_dtype],
                      torch.cuda.current_stream(x8.device).cuda_stream)
    _build.check(rc, "conv_s8")
    conv_s8.launches += 1
    return out


conv_s8.launches = 0
