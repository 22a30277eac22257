"""Width packing: (B, H, W, C) <-> (B, H, W/P, P*C), and the pack-factor change.

Counterpart of `lpc_yolo_tpu/nn/modules.py` `pack_width` / `unpack_width` /
`repack_width` (plain reshapes) and of the TPU kernel
`lpc_yolo_tpu/ops/pallas_layout.py::repack_width_pallas`, which
`repack_width_kernel` replaces (`csrc/repack.cu`).

The element order of a width-packed buffer does not depend on P, so on
contiguous storage every one of these is a view. The kernel earns its launch
where the input is strided in B, H or W/P (a slice of a larger staging
buffer): it then gathers the slice into a contiguous output in one pass. The
training step receives its batches width-packed x8 (`(B, H, W/8, 24)` uint8)
and unpacks them through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build


def pack_width(x: torch.Tensor, P: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W/P, P*C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w // P, P * c)


def unpack_width(x: torch.Tensor, P: int) -> torch.Tensor:
    """(B, H, W/P, P*C) -> (B, H, W, C)."""
    b, h, wp, pc = x.shape
    return x.reshape(b, h, wp * P, pc // P)


def repack_width(x: torch.Tensor, p_from: int, p_to: int) -> torch.Tensor:
    """(B, H, W/p_from, p_from*C) -> (B, H, W/p_to, p_to*C), any p_from -> p_to."""
    if p_from == p_to:
        return x
    b, h, wp, pc = x.shape
    return x.reshape(b, h, wp * p_from // p_to, p_to * (pc // p_from))


def _check(x: torch.Tensor, p_from: int, p_to: int) -> Tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"expected a (B, H, W/p_from, p_from*C) tensor, got {tuple(x.shape)}")
    if p_to < 1 or p_from % p_to != 0 or p_from <= p_to or x.shape[3] % p_from != 0:
        raise ValueError(f"p_to must divide p_from, p_to < p_from, and p_from must divide the last "
                         f"dimension: p_from {p_from}, p_to {p_to}, last dimension {x.shape[3]}")
    b, h, wf, pfc = x.shape
    return b, h, wf * (p_from // p_to), pfc // (p_from // p_to)


def repack_width_plain(x: torch.Tensor, p_from: int, p_to: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the reshape of the (made-contiguous) input."""
    return x.contiguous().reshape(_check(x, p_from, p_to))


def copy_plan(shape, strides, itemsize: int, address: int):
    """The kernel's byte-level plan for a (B, H, Wf, K) input with contiguous K.

    Returns ((n0, n1, n2), (s0, s1, s2), run, vec): the input is n0*n1*n2 runs
    of `run` contiguous bytes at byte strides s0, s1, s2 (every trailing
    dimension that is itself contiguous is folded into the run), copied with
    accesses of `vec` bytes, the widest of 16, 8, 4, 2, 1 that divides the
    run, the strides and the address.
    """
    dims = [(int(n), int(s) * itemsize) for n, s in zip(shape[:3], strides[:3])]
    run = int(shape[3]) * itemsize
    while dims and (dims[-1][1] == run or dims[-1][0] == 1):
        run *= dims.pop()[0]
    dims = [(1, 0)] * (3 - len(dims)) + dims
    vec = 16
    while vec > 1 and (run % vec or address % vec or any(s % vec for _, s in dims)):
        vec //= 2
    return tuple(n for n, _ in dims), tuple(s for _, s in dims), run, vec


def repack_width_kernel(x: torch.Tensor, p_from: int, p_to: int) -> torch.Tensor:
    """Pack-factor change through the hand-written kernel: out[b, h, wi*r + q, j]
    = x[b, h, wi, q*ptc + j] with r = p_from/p_to, ptc = p_to*C; p_to == 1 unpacks.

    x may be strided in B, H and W/p_from; its last dimension is contiguous.
    The output is a new contiguous tensor of x's dtype (any element size). CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    """
    out_shape = _check(x, p_from, p_to)
    if x.device.type == "cpu":
        return repack_width_plain(x, p_from, p_to)
    if x.device.type != "cuda":
        raise ValueError(f"repack_width_kernel runs on CUDA tensors, got {x.device}")
    if x.shape[3] > 1 and x.stride(3) != 1:
        raise ValueError("repack_width_kernel needs a contiguous last dimension")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    (n0, n1, n2), (s0, s1, s2), run, vec = copy_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
    lib = _build.load("repack")
    fn = lib.repack_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), n0, n1, n2, s0, s1, s2, run, vec, stream)
    _build.check(rc, "repack")
    repack_width_kernel.launches += 1
    return out


repack_width_kernel.launches = 0
