"""Per-tensor symmetric int8 quantization of an activation into a channel slice of an s8 buffer (NHWC).

Replaces no TPU kernel: the JAX package quantizes in XLA passes ahead of its int8 convs
(`lpc_yolo_tpu/nn/quant.py:131`, `:142-147`). The kernel (`csrc/quantize_s8.cu`) writes
`clip(rint(x * inv), -127, 127)` (half to even) of one part straight into its channel slice of the s8
buffer that `ops/conv_s8.py` reads: a plain site's input, each part of a C2f / C2fCIB concat tail, the
four parts of the SPPF tail. `inv` is the f32 of the double `1 / sx` (`nn/quant.py::act_scale`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_s8_plain(x: torch.Tensor, inv: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the same function in f32 (`inv` is f32-exact, so the product rounds as the
    kernel's); writes into `out` when given."""
    q = torch.round(x.float() * inv).clamp_(-127, 127).to(torch.int8)
    if out is None:
        return q
    out.copy_(q)
    return out


# quantize_s8_launch(x, y, B, H, W, C, sxb, sxh, sxw, sxc, syp, inv, dtype, stream)
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 5 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p])
_entry = None


def _launch_fn():
    global _entry
    if _entry is None:
        fn = _build.load("quantize_s8").quantize_s8_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def quantize_s8(x: torch.Tensor, inv: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C) f32 / bf16 NHWC, any strides -> s8 (B, H, W, C): `out` (a channel slice of an NHWC s8
    buffer, channels contiguous), written in place and returned, or a new contiguous tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    if x.dim() != 4:
        raise ValueError(f"quantize_s8 takes an NHWC (B, H, W, C) tensor, got {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != torch.int8):
        raise ValueError(f"out must be an s8 tensor of x's shape {tuple(x.shape)}, got {out.dtype} {tuple(out.shape)}")
    if x.device.type == "cpu":
        return quantize_s8_plain(x, inv, out)
    if x.device.type != "cuda" or x.dtype not in DTYPES:
        raise ValueError(f"quantize_s8 takes an f32 or bf16 CUDA tensor, got {x.dtype} on {x.device}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out.device != x.device or out.stride(3) != 1 or out.stride(1) != out.stride(2) * x.shape[2] or \
            out.stride(0) != out.stride(1) * x.shape[1]:
        raise ValueError("out must be a channel slice of a contiguous NHWC s8 buffer on x's device")
    B, H, W, C = x.shape
    rc = _launch_fn()(x.data_ptr(), out.data_ptr(), B, H, W, C, *x.stride(), out.stride(2), float(inv),
                      DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantize_s8")
    quantize_s8.launches += 1
    return out


quantize_s8.launches = 0
