"""Instance masks: decode, the letterbox undo, polygons, and a polygon fill (counterpart of
`lpc_yolo_tpu/ops/masks.py`, crop_mask :20, process_mask :34, masks2segments :54,
scale_image :74, scale_masks :97).

`process_mask` is sigmoid(coeffs @ protos), cropped to each box in proto
pixels and, with `upsample`, resized bilinearly to the network input (JAX
`jax.image.resize(..., "bilinear")`: half-pixel centres, edges clamped, which is
`F.interpolate(..., align_corners=False)` when the size grows). The
coefficients-by-prototypes product is a plain matrix product, outside any
Pallas kernel in the JAX package, and stays `torch.matmul` here.

`unletterbox_masks` undoes the letterbox on decoded masks as the JAX
predictor does (:328-340): the pad cropped at `round(pad)`, then cv2's f32
`INTER_LINEAR` resize to the frame (`resize_linear`: cv2's weights and its
fused lerp, in torch on any device), then `> 0.5`. The card's machine has no
OpenCV.

`masks2segments` traces each mask's outer borders with
`data/cvops.py::find_external_contours` (cv2.findContours, RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE, without OpenCV). `scale_image` crops the letterbox pad of
an (H, W[, C]) array and resizes it as cv2.resize (INTER_LINEAR) does: uint8
through `data/cvops.py::resize`, f32 through `resize_linear`. `scale_masks`
crops the pad of (..., H, W) masks and resizes them as `jax.image.resize(...,
"bilinear")` does (antialiased when it shrinks): a triangle kernel's weights in
f32 along each axis, normalised, contracted with the masks.

`fill_poly` is `cv2.fillPoly(img, [pts], color)` for one int32 polygon
(`LINE_8`, shift 0) bit for bit, in numpy on the host: cv2's Bresenham
outline of every edge (clipped as cv2 clips), then its scanline fill over
16.16 fixed-point edges (a clipped edge takes its clipped end's x, and its
y where the clipped ends differ in y), each row's crossings sorted and
paired, a span from the ceiling of the left one to the floor of the right.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

XY_SHIFT = 16  # cv2's fixed-point fraction bits in fillPoly
RESIZE_CHUNK = 8  # masks resized at a time


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero the pixels of each (N, H, W) mask outside its (N, 4) xyxy box (mask pixels)."""
    n, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None].unbind(1)  # each (N, 1)
    c = torch.arange(w, device=masks.device, dtype=torch.float32)[None, None, :]
    r = torch.arange(h, device=masks.device, dtype=torch.float32)[None, :, None]
    keep = (c >= x1[..., None]) & (c < x2[..., None]) & (r >= y1[..., None]) & (r < y2[..., None])
    return masks * keep


def process_mask(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor, shape: Tuple[int, int],
                 upsample: bool = False) -> torch.Tensor:
    """N instance masks of one image, f32 sigmoid values: (N, mh, mw), or (N, h, w) with upsample.

    protos (nm, mh, mw) (the NCHW model's layout); coeffs (N, nm); boxes (N, 4) xyxy in the
    pixels of the network input `shape` (h, w).
    """
    nm, mh, mw = protos.shape
    masks = torch.sigmoid(coeffs.float() @ protos.float().reshape(nm, -1)).view(-1, mh, mw)
    ih, iw = shape
    scale = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih], dtype=torch.float32, device=boxes.device)
    masks = crop_mask(masks, boxes.float() * scale)
    if upsample:
        masks = F.interpolate(masks[None], size=(ih, iw), mode="bilinear", align_corners=False)[0]
    return masks


def process_kept_rows(protos: torch.Tensor, coeffs: torch.Tensor, det: torch.Tensor, keep: np.ndarray,
                      size: int) -> torch.Tensor:
    """`process_mask(..., upsample=True)` of one image's rows that `keep` (host bool (max_det,)) marks:
    (n, size, size) f32 on the rows' device. The predictor and the validator decode only these rows."""
    rows = torch.from_numpy(np.nonzero(keep)[0]).to(det.device)
    return process_mask(protos, coeffs[rows], det[rows, :4], (size, size), upsample=True)


def _linear_taps(src: int, dst: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2's INTER_LINEAR taps along one axis: the first source pixel, the second (the next one,
    clamped) and the f32 weight of the second: the fraction of (d + 0.5) * src / dst - 0.5 taken in
    f64, then rounded to f32; 0 where the first pixel clamps at a border."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    frac = f - s
    frac[(s < 0) | (s >= src - 1)] = 0
    s = np.clip(s, 0, src - 1)
    return (torch.from_numpy(s).to(device), torch.from_numpy(np.minimum(s + 1, src - 1)).to(device),
            torch.from_numpy(frac.astype(np.float32)).to(device))


def _lerp(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """cv2's f32 a + (b - a) * w with the multiply-add fused: (b - a) rounded to f32, the rest in
    f64 (the product of two f32 is exact there), then rounded once to f32."""
    return ((b - a).double() * w.double() + a.double()).float()


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(x_i, (w, h), interpolation=INTER_LINEAR) of each f32 (H, W) plane of (N, H, W):
    (N, h, w), a horizontal pass, then a vertical one, each cv2's fused lerp (bit for bit with
    OpenCV 5.0 on the CPU, exact 2x downscales included). RESIZE_CHUNK planes at a time bound the
    f64 temporaries."""
    chunk = RESIZE_CHUNK
    n, hs, ws = x.shape
    h, w = size
    x = x.float()
    if (hs, ws) == (h, w):
        return x.clone()
    sx, nx, ax = _linear_taps(ws, w, x.device)
    sy, ny, ay = _linear_taps(hs, h, x.device)
    out = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    for i in range(0, n, chunk):
        xi = x[i:i + chunk]
        rows = _lerp(xi[:, :, sx], xi[:, :, nx], ax)  # (c, Hs, w)
        out[i:i + chunk] = _lerp(rows[:, sy, :], rows[:, ny, :], ay[:, None])
    return out


def unletterbox_masks(masks: torch.Tensor, imgsz: int, orig_shape: Tuple[int, int]) -> torch.Tensor:
    """(n, imgsz, imgsz) sigmoid masks in letterbox pixels -> (n, h0, w0) bool masks of the frame:
    the pad cropped at round(pad) (the JAX predictor's rounding), cv2's f32 linear resize, > 0.5."""
    h0, w0 = orig_shape
    gain = min(imgsz / h0, imgsz / w0)
    pw, ph = (imgsz - w0 * gain) / 2, (imgsz - h0 * gain) / 2
    y1, y2 = int(round(ph)), int(round(imgsz - ph))
    x1, x2 = int(round(pw)), int(round(imgsz - pw))
    return resize_linear(masks[:, y1:y2, x1:x2], (h0, w0)) > 0.5


def masks2segments(masks, strategy: str = "largest") -> List[np.ndarray]:
    """(N, H, W) binary masks -> one (n, 2) f32 polygon each: the outer border with the most points
    ("largest") or all outer borders end to end ("concat"); (0, 2) for an empty mask."""
    from ..data.cvops import find_external_contours

    out = []
    for m in np.asarray(masks).astype(np.uint8):
        cs = find_external_contours(m)
        if cs:
            seg = np.concatenate([c.reshape(-1, 2) for c in cs]) if strategy == "concat" else max(cs, key=len).reshape(-1, 2)
        else:
            seg = np.zeros((0, 2))
        out.append(seg.astype(np.float32))
    return out


def _letterbox_crop(hw: Tuple[int, int], shape: Sequence[int], pad=None) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of the content of a letterboxed (h, w) array whose frame is `shape`;
    `pad` (pad_w, pad_h) when given, else the centred pad of the gain min(h / h0, w / w0)."""
    h, w = hw
    if pad is None:
        gain = min(h / shape[0], w / shape[1])
        pad = ((w - shape[1] * gain) / 2, (h - shape[0] * gain) / 2)
    return (int(round(pad[1] - 0.1)), h - int(round(pad[1] + 0.1)),
            int(round(pad[0] - 0.1)), w - int(round(pad[0] + 0.1)))


def scale_image(masks: np.ndarray, im0_shape: Sequence[int], ratio_pad=None) -> np.ndarray:
    """Undo the letterbox on an (H, W) or (H, W, C) uint8 or f32 array: crop the pad (`ratio_pad`'s
    (ratio, (pad_w, pad_h)) when given) and resize to im0_shape (h0, w0) as cv2.resize does (INTER_LINEAR;
    a single channel comes out (h0, w0), as from cv2); the array itself when its size is already the
    frame's. cv2's own f32 path for 2 or more than 4 channels rounds otherwise: those planes are resized
    one at a time, as cv2 resizes a single plane."""
    from ..data.cvops import resize

    masks = np.asarray(masks)
    if masks.shape[:2] == tuple(im0_shape[:2]):
        return masks
    top, bottom, left, right = _letterbox_crop(masks.shape[:2], im0_shape, None if ratio_pad is None else ratio_pad[1])
    crop = masks[top:bottom, left:right]
    h0, w0 = int(im0_shape[0]), int(im0_shape[1])
    planes = crop.reshape(*crop.shape[:2], -1)
    c = planes.shape[-1]
    if crop.dtype == np.uint8:  # cv2's fixed-point path, the same for every channel: three at a time
        k = -(-c // 3) * 3
        src = np.zeros((*planes.shape[:2], k), np.uint8)
        src[..., :c] = planes
        src = torch.from_numpy(src).reshape(*planes.shape[:2], k // 3, 3).permute(2, 0, 1, 3)
        out = resize(src.contiguous(), (w0, h0)).permute(1, 2, 0, 3).reshape(h0, w0, k)[..., :c].numpy()
    elif crop.dtype == np.float32:
        out = resize_linear(torch.from_numpy(np.ascontiguousarray(planes.transpose(2, 0, 1))), (h0, w0))
        out = out.permute(1, 2, 0).numpy()
    else:
        raise TypeError(f"scale_image takes uint8 or float32 arrays, got {crop.dtype}")
    return out.reshape(h0, w0) if c == 1 else out


def _triangle_weights(n_in: int, n_out: int) -> torch.Tensor:
    """`jax.image.resize`'s (n_in, n_out) f32 weights of the triangle kernel along one axis: sample
    points (i + 0.5) / scale - 0.5, the kernel widened by 1 / scale when it shrinks, each column
    normalised by its sum, zero where the sample lies outside the input."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    ks = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.0) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / ks
    w = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0).astype(f32))


def scale_masks(masks: torch.Tensor, shape: Sequence[int], padding: bool = True) -> torch.Tensor:
    """(..., H, W) letterboxed masks -> (..., h, w) at `shape`: the centred pad cropped (with `padding`),
    then `jax.image.resize(..., "bilinear")`'s resize in f32."""
    mh, mw = masks.shape[-2:]
    if padding:
        top, bottom, left, right = _letterbox_crop((mh, mw), shape)
        masks = masks[..., top:bottom, left:right]
    x = masks.float()
    h, w = int(shape[0]), int(shape[1])
    if x.shape[-2] != h:
        x = torch.einsum("...hw,hH->...Hw", x, _triangle_weights(x.shape[-2], h).to(x.device))
    if x.shape[-1] != w:
        x = torch.einsum("...hw,wW->...hW", x, _triangle_weights(x.shape[-1], w).to(x.device))
    return x


# -- cv2.fillPoly ----------------------------------------------------------------------------


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C's integer division (toward zero) of int64 arrays."""
    q = np.abs(a) // np.maximum(np.abs(b), 1)
    return np.where((a < 0) != (b < 0), -q, q)


def _clip_lines(w: int, h: int, p1: np.ndarray, p2: np.ndarray):
    """cv2's clipLine(Size(w, h), pt1, pt2) on (E, 2) int64 endpoints, in its order of steps
    (the second endpoint's step sees the first one already moved): (inside, p1, p2)."""
    x1, y1, x2, y2 = (v.copy() for v in (p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1]))
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) * 1 + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def step(num_a, den_a, num_b, den_b, a_minus):  # (int64)((double)(a - v) * (num) / (den))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = a_minus.astype(np.float64) * (num_a - num_b).astype(np.float64) / (den_a - den_b).astype(np.float64)
        return np.where(np.isfinite(t), np.trunc(t), 0).astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = go & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + step(x2, y2, x1, y1, a - y1), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, (x1 < 0) * 1 + (x1 > right) * 2, c1)
    m = go & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + step(x2, y2, x1, y1, a - y2), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, (x2 < 0) * 1 + (x2 > right) * 2, c2)
    go2 = go & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = go2 & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + step(y2, x2, y1, x1, a - x1), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = go2 & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + step(y2, x2, y1, x1, a - x2), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return (c1 | c2) == 0, np.stack([x1, y1], 1), np.stack([x2, y2], 1)


def _outline(w: int, h: int, p1: np.ndarray, p2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels (ys, xs) of cv2's 8-connected lines p1[i] -> p2[i] (LineIterator, left to right,
    clipped to the image first when an end lies outside it)."""
    out = ~((p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)
            & (p2[:, 0] >= 0) & (p2[:, 0] < w) & (p2[:, 1] >= 0) & (p2[:, 1] < h))
    inside, c1, c2 = _clip_lines(w, h, p1, p2)
    keep = ~out | inside
    p1 = np.where(out[:, None], c1, p1)[keep]
    p2 = np.where(out[:, None], c2, p2)[keep]
    swap = p2[:, 0] < p1[:, 0]
    p1, p2 = np.where(swap[:, None], p2, p1), np.where(swap[:, None], p1, p2)
    dx, dy = p2[:, 0] - p1[:, 0], p2[:, 1] - p1[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    big, small = np.maximum(dx, dy), np.minimum(dx, dy)
    n = big + 1
    e = np.repeat(np.arange(len(n)), n)
    i = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    k = np.maximum(2 * small[e] * i + big[e] - 1, 0) // np.maximum(2 * big[e], 1)  # minor steps taken (Bresenham)
    xs = np.where(vert[e], p1[e, 0] + k, p1[e, 0] + i)
    ys = np.where(vert[e], p1[e, 1] + sy[e] * i, p1[e, 1] + sy[e] * k)
    return ys, xs


def fill_poly(img: np.ndarray, pts: np.ndarray, color: int = 1) -> np.ndarray:
    """cv2.fillPoly(img, [pts], color) for one polygon of int32 (k, 2) vertices on a 2-D uint8
    image, in place (LINE_8, shift 0); returns img."""
    h, w = img.shape
    v = np.asarray(pts).reshape(-1, 2).astype(np.int64)
    if len(v) == 0 or h == 0 or w == 0:
        return img
    p0, p1 = np.roll(v, 1, axis=0), v  # edge i runs from vertex i - 1 to vertex i
    ys, xs = _outline(w, h, p0, p1)
    img[ys, xs] = color

    # the fill's edges, in 16.16 fixed point
    e = p0[:, 1] != p1[:, 1]
    if e.sum() < 2:
        return img
    p0, p1 = p0[e], p1[e]
    out = ~((p0[:, 0] >= 0) & (p0[:, 0] < w) & (p0[:, 1] >= 0) & (p0[:, 1] < h)
            & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h))
    _, c0, c1 = _clip_lines(w, h, p0, p1)
    q0 = np.stack([np.where(out, c0[:, 0], p0[:, 0]) << XY_SHIFT, p0[:, 1]], 1)
    q1 = np.stack([np.where(out, c1[:, 0], p1[:, 0]) << XY_SHIFT, p1[:, 1]], 1)
    newy = out & (c0[:, 1] != c1[:, 1])
    q0[:, 1] = np.where(newy, c0[:, 1], q0[:, 1])
    q1[:, 1] = np.where(newy, c1[:, 1], q1[:, 1])
    dx = _trunc_div(q1[:, 0] - q0[:, 0], q1[:, 1] - q0[:, 1])
    down = p0[:, 1] < p1[:, 1]
    y0 = np.where(down, p0[:, 1], p1[:, 1])
    y1 = np.where(down, p1[:, 1], p0[:, 1])
    top = np.where(down[:, None], q0, q1)
    x0 = top[:, 0] + (y0 - top[:, 1]) * dx

    r0, r1 = max(int(y0.min()), 0), min(int(y1.max()), h)
    if r1 <= r0:
        return img
    rows = np.arange(r0, r1)
    active = (rows[:, None] >= y0[None]) & (rows[:, None] < y1[None])  # (R, E)
    x = np.where(active, x0[None] + (rows[:, None] - y0[None]) * dx[None], 1 << 62)  # inactive: sorted last
    x.sort(axis=1)
    if x.shape[1] % 2:
        x = np.concatenate([x, np.full((len(rows), 1), 1 << 62)], 1)
    left, right = x[:, 0::2], x[:, 1::2]  # each row's crossings paired in x order
    pair = 2 * np.arange(left.shape[1])[None] + 1 < active.sum(1)[:, None]
    xa = (left + ((1 << XY_SHIFT) - 1)) >> XY_SHIFT
    xb = right >> XY_SHIFT
    pair &= (xa < w) & (xb >= 0)
    xa, xb = np.clip(xa, 0, w), np.clip(xb, -1, w - 1)
    ri, ci = np.nonzero(pair)
    mark = np.zeros((len(rows), w + 1), np.int32)
    np.add.at(mark, (ri, xa[ri, ci]), 1)
    np.add.at(mark, (ri, xb[ri, ci] + 1), -1)
    fill = np.cumsum(mark[:, :w], axis=1) > 0
    img[r0:r1][fill] = color
    return img
