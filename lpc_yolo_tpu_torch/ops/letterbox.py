"""Letterbox on the device: the cv2 LetterBox of uint8 BGR frames, one launch.

Replaces the TPU kernel `lpc_yolo_tpu/ops/pallas_preprocess.py::letterbox_pallas`
(`_letterbox_kernel`), which resized as two dense MXU products `Ry·src·Rx`.
Each row of those matrices has at most two non-zero taps, so on the H100 the
kernel (`csrc/letterbox.cu`) gathers the two taps per axis from small tables
instead: one thread per output pixel, vertical pass then horizontal pass in
f32, exactly the order of `Ry·src` then `·Rx`. The work is a few operations
per byte, so the card's memory rate bounds it (read each frame once, write the
(S, S, 3) image once); the design reads every source pixel through the cache
at most a few times and writes the model's input batch in place, in the
model's dtype, so no separate normalize or layout pass follows.

Tables: per axis, `(i0, i1, wa, wb)` with `i0 = -1` for rows/columns of the
pad. They are taken from the same sampling as `build_letterbox_mats` (half-
pixel centres, clamped, with the reference's ±0.1 pad split) and reproduce its
matrices entry for entry, including the clamped edge where `i0 == i1`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

PAD = 114
MODES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def letterbox_geometry(
    shape: Tuple[int, int], new_shape: Tuple[int, int], scaleup: bool = True
) -> Tuple[float, Tuple[int, int], Tuple[float, float]]:
    """(gain, (new_w, new_h), (pad_w, pad_h)) of the reference LetterBox: centre
    the image, no stride-multiple pad; `scaleup=False` (validation) never
    enlarges a frame smaller than the target."""
    h0, w0 = shape
    nh, nw = new_shape
    r = min(nh / h0, nw / w0)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(w0 * r)), int(round(h0 * r))
    return r, new_unpad, ((nw - new_unpad[0]) / 2, (nh - new_unpad[1]) / 2)


def _axis_taps(n_src: int, n_dst: int, offset: int, out_len: int) -> np.ndarray:
    """(4, out_len) rows i0, i1, wa, wb (weights as f32 bits in an int32 array).

    wa/wb are the f32 matrix entries `build_letterbox_mats` accumulates
    (`M[o, i0] += 1 - w1; M[o, i1] += w1`), so a clamped tap (i0 == i1)
    carries the sum in wa and zero in wb.
    """
    i0s = np.full(out_len, -1, np.int32)
    i1s = np.full(out_len, -1, np.int32)
    was = np.zeros(out_len, np.float32)
    wbs = np.zeros(out_len, np.float32)
    scale = n_src / n_dst
    for o in range(n_dst):
        f = (o + 0.5) * scale - 0.5
        f = min(max(f, 0.0), n_src - 1)
        i0 = int(np.floor(f))
        i1 = min(i0 + 1, n_src - 1)
        w1 = f - i0
        m = np.zeros(2, np.float32)
        m[0] += 1.0 - w1
        if i1 == i0:
            m[0] += w1
        else:
            m[1] += w1
        i0s[o + offset], i1s[o + offset] = i0, i1
        was[o + offset], wbs[o + offset] = m
    return np.stack([i0s, i1s, was.view(np.int32), wbs.view(np.int32)])


@functools.lru_cache(maxsize=32)
def letterbox_tables(h0: int, w0: int, size: int, scaleup: bool = True) -> np.ndarray:
    """(8, size) int32: rows y_i0, y_i1, y_wa, y_wb, x_i0, x_i1, x_wa, x_wb.

    Cached per frame shape and `scaleup` (a camera stream reuses one); callers
    must not write to the returned array. With r = 1 (`scaleup=False` on a
    frame that fits) every tap is the identity: i0 = o, wa = 1, wb = 0.
    """
    _, (new_w, new_h), (dw, dh) = letterbox_geometry((h0, w0), (size, size), scaleup)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    tab = np.concatenate([_axis_taps(h0, new_h, top, size), _axis_taps(w0, new_w, left, size)])
    tab.setflags(write=False)
    return tab


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, np.int32))
    # pinned source and an async copy: the host never waits for the stream
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


@functools.lru_cache(maxsize=32)
def tables_on(h0: int, w0: int, size: int, device: torch.device, scaleup: bool = True) -> torch.Tensor:
    """`letterbox_tables` as an int32 tensor on `device`, copied there once per
    frame shape; callers must not write to it."""
    return _on(letterbox_tables(h0, w0, size, scaleup), device)


@functools.lru_cache(maxsize=256)
def _slots_on(slots: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return _on(np.asarray(slots), device)


def build_letterbox_mats(h0: int, w0: int, size: int, scaleup: bool = True):
    """Dense Ry (size, h0), Rx (w0, size) and pad_mask (size, size), scattered
    from the gather tables: the matrices the TPU kernel multiplies by."""
    tab = letterbox_tables(h0, w0, size, scaleup)

    def dense(rows, n_src):
        i0, i1 = rows[0], rows[1]
        wa, wb = rows[2].view(np.float32), rows[3].view(np.float32)
        M = np.zeros((size, n_src), np.float32)
        o = np.nonzero(i0 >= 0)[0]
        M[o, i0[o]] += wa[o]
        M[o, i1[o]] += wb[o]
        return M

    Ry, Rx = dense(tab[:4], h0), dense(tab[4:], w0).T
    pad = 1.0 - ((tab[0] >= 0)[:, None] & (tab[4] >= 0)[None, :]).astype(np.float32)
    return Ry, Rx, pad


def letterbox_plain(frames: torch.Tensor, tab: torch.Tensor, size: int, out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (n, h0, w0, 3) u8 BGR -> (n, S, S, 3) RGB."""
    i0y, i1y, i0x, i1x = tab[0].long(), tab[1].long(), tab[4].long(), tab[5].long()
    way, wby = tab[2].view(torch.float32), tab[3].view(torch.float32)
    wax, wbx = tab[6].view(torch.float32), tab[7].view(torch.float32)
    in_y, in_x = i0y >= 0, i0x >= 0
    src = frames.flip(-1).float()  # BGR -> RGB
    cy, cx = i0y.clamp(min=0), i0x.clamp(min=0)
    dy, dx = i1y.clamp(min=0), i1x.clamp(min=0)
    # vertical taps first (Ry·src), then horizontal (·Rx), all in f32
    a = way[:, None, None] * src[:, cy] + wby[:, None, None] * src[:, dy]  # (n, S, w0, 3)
    v = wax[:, None] * a[:, :, cx] + wbx[:, None] * a[:, :, dx]  # (n, S, S, 3)
    content = (in_y[:, None] & in_x[None, :])[None, :, :, None]
    if out_dtype == torch.uint8:
        return torch.where(content, v.round().clamp(0, 255), float(PAD)).to(torch.uint8)
    v = torch.where(content, v * (1.0 / 255.0), torch.tensor(PAD / 255.0, dtype=torch.float32))
    return v.to(out_dtype)


def letterbox(
    frames: torch.Tensor,
    size: int = 640,
    out: Optional[torch.Tensor] = None,
    slots: Optional[Sequence[int]] = None,
    out_dtype=torch.float32,
    scaleup: bool = True,
) -> torch.Tensor:
    """Letterbox SAME-SHAPE uint8 BGR frames (n, h0, w0, 3) into RGB (N, S, S, 3).

    Counterpart of the JAX `letterbox_batch_device`. The result is
    normalized to [0, 1] (pad 114/255) in f32/bf16, or the 0..255 frame (pad 114) in uint8. With `out` given (a contiguous
    (N, S, S, 3) batch), frame f is written into `out[slots[f]]` in place:
    the predictor letterboxes each group of equal-shape frames straight into
    its slots of the model's input batch. CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch for the whole group).
    `scaleup=False` is the validator's geometry: frames smaller than `size`
    keep their size and are only padded.
    """
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (n, h0, w0, 3) uint8 frames, got {tuple(frames.shape)} {frames.dtype}")
    n, h0, w0 = frames.shape[:3]
    if out is None:
        out = torch.empty((n, size, size, 3), dtype=out_dtype, device=frames.device)
    if out.dtype not in MODES or out.shape[1:] != (size, size, 3) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous (N, {size}, {size}, 3) u8/f32/bf16 tensor")
    slot_list = tuple(range(n)) if slots is None else tuple(int(s) for s in slots)
    if len(slot_list) != n or not all(0 <= s < out.shape[0] for s in slot_list):
        raise ValueError(f"slots {slot_list} do not fit a batch of {out.shape[0]}")
    dev = frames.device
    if dev.type == "cpu":
        out[list(slot_list)] = letterbox_plain(frames, tables_on(int(h0), int(w0), size, dev, scaleup), size, out.dtype)
        return out
    if dev.type != "cuda" or out.device != dev:
        raise ValueError("frames and out must lie on the same CUDA device")
    frames = frames.contiguous()
    tab_d = tables_on(int(h0), int(w0), size, dev, scaleup)
    slots_d = _slots_on(slot_list, dev)
    lib = _build.load("letterbox")
    fn = lib.letterbox_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(frames.data_ptr(), tab_d.data_ptr(), slots_d.data_ptr(), out.data_ptr(),
            n, int(h0), int(w0), size, MODES[out.dtype], stream)
    _build.check(rc, "letterbox")
    letterbox.launches += 1
    return out


letterbox.launches = 0
