"""OpenCV's uint8 image ops of the training pipeline, written on tensors.

The JAX package augments on the host with cv2 (`lpc_yolo_tpu/data/augment.py`:
`cv2.resize` :134, `warpPerspective` :224, `warpAffine` :226, `cvtColor` BGR<->HSV and `LUT`
:289-295; `ops/letterbox.py:65-68`). The machine with the card has no
OpenCV, and a near miss does not do: the hue conversion turns a 1-LSB
difference after a resize into up to 18 LSB after the HSV jitter. So each op
here reproduces the integer and float32 arithmetic of OpenCV 5.0's
vectorised paths, batched, on whatever device the tensors live on:

- `resize` (INTER_LINEAR): coefficients rint(f * 2048) with f in f32, a
  horizontal pass into int32 and the vertical pass of the SIMD path,
  ((((h0 >> 4) * b0) >> 16) + (((h1 >> 4) * b1) >> 16) + 2) >> 2. An exact 2x
  downscale switches to INTER_AREA, (a + b + c + d + 2) >> 2, which is the
  same formula with two taps of weight 1024 per axis.
- `warp_affine` (INTER_LINEAR, BORDER_CONSTANT): the inverse matrix in f64,
  then f32; source coordinates fma(x, m0, y * m1 + m2) and the three lerps
  p = fma(a, p01 - p00, p00) as fused multiply-adds in f32, rounded with
  rint. A fused multiply-add is emulated exactly in f64: the product of two
  f32 values is exact there.
- `warp_perspective` (the same interpolation and border): the inverse by
  cv2.invert's 3x3 cofactor formula in f64, then f32; X = fma(x, m0, y * m1
  + m2), Y and W alike, and the source point (X / W, Y / W) divided in f32.
  Both warps are bit-exact where the output width is a multiple of 16
  (cv2's vector loop); cv2's scalar tail of other widths rounds otherwise.
- `bgr2hsv`: cv2's integer path (shift 12, `sdiv`/`hdiv` tables).
- `hsv2bgr`: cv2's f32 path with its fused multiply-adds, truncated to u8.
- `lut` and `blend` (mixup). The host letterbox's constant border is the
  render's canvas fill (`BORDER`).
- `min_area_rect`: cv2.minAreaRect of small point sets (a DOTA row's quad),
  in numpy: cv2's convex hull order (Sklansky from the rightmost point, then
  its cyclic shift of the indices), the rotating calipers in f32 with
  cv2's cross-product test for the leading edge, and OpenCV 5.0's angle in
  [-90, 0): an axis-aligned rectangle is -90 with its vertical side as w.

Each is held against cv2 in `tests/test_torch_data.py`. The batched training
render (`data/augment.py::render`) builds on the same cores.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

RESIZE_BITS = 11  # INTER_RESIZE_COEF_BITS: resize coefficients sum to 2048
BORDER = 114  # the pipeline's pad and border value

_HSV_SHIFT = 12
_i = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _i)]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _i))]).astype(np.int32)
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.int64)
del _i


def axis_taps(n_src: int, n_dst: int, scale: float, clamp_weights: bool) -> np.ndarray:
    """cv2's INTER_LINEAR taps along one axis: (4, n_dst) int64 rows (i0, i1, w0, w1).

    `scale` is cv2's `1 / (n_dst / n_src)` in f64; f = f32((d + 0.5) * scale - 0.5).
    Along x (clamp_weights) a tap left of the image or at its last column
    takes weights (2048, 0); along y cv2 keeps the weights and clamps the rows.
    """
    d = np.arange(n_dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= n_src - 1
        f[lo | hi] = 0
        s[lo], s[hi] = 0, n_src - 1
    w1 = np.rint(f * np.float32(1 << RESIZE_BITS)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(1 << RESIZE_BITS)).astype(np.int64)
    return np.stack([np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1])


def resize_taps(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(rows (4, H), cols (4, W)) of cv2.resize INTER_LINEAR from src_hw to dst_hw,
    with cv2's switch to INTER_AREA on an exact 2x downscale."""
    (h0, w0), (h, w) = src_hw, dst_hw
    sy, sx = 1.0 / (h / h0), 1.0 / (w / w0)
    if abs(sx - 2) < np.finfo(np.float64).eps and abs(sy - 2) < np.finfo(np.float64).eps:
        half = np.full(h, 1 << (RESIZE_BITS - 1)), np.full(w, 1 << (RESIZE_BITS - 1))
        return (np.stack([2 * np.arange(h), 2 * np.arange(h) + 1, half[0], half[0]]),
                np.stack([2 * np.arange(w), 2 * np.arange(w) + 1, half[1], half[1]]))
    return axis_taps(h0, h, sy, False), axis_taps(w0, w, sx, True)


def fixed_bilinear(pool3: torch.Tensor, r0, r1, b0, b1, c0, c1, a0, a1) -> torch.Tensor:
    """cv2.resize's fixed-point bilinear over a flat (P, 3) uint8 pixel pool -> int32 (..., 3).

    r0/r1: pixel offsets of the two source rows (base + row * width), c0/c1
    the two source columns, a*/b* their weights; all int tensors that
    broadcast to the output's pixel shape.
    """

    def px(r, c):
        idx = (r + c).long()
        return pool3.index_select(0, idx.reshape(-1)).view(*idx.shape, 3).int()

    a0, a1 = a0.int()[..., None], a1.int()[..., None]
    h0 = px(r0, c0) * a0 + px(r0, c1) * a1
    h1 = px(r1, c0) * a0 + px(r1, c1) * a1
    v = (((h0 >> 4) * b0.int()[..., None]) >> 16) + (((h1 >> 4) * b1.int()[..., None]) >> 16)
    return ((v + 2) >> 2).clamp_(0, 255)


def resize(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, dsize, interpolation=INTER_LINEAR) of (N, h, w, 3) uint8 frames;
    dsize is (width, height) as cv2 takes it. Returns (N, H, W, 3) uint8."""
    n, h0, w0, _ = img.shape
    w, h = dsize
    rows, cols = (torch.from_numpy(t).to(img.device) for t in resize_taps((h0, w0), (h, w)))
    base = (torch.arange(n, device=img.device) * (h0 * w0))[:, None, None]
    r0, r1 = base + rows[0][:, None] * w0, base + rows[1][:, None] * w0
    out = fixed_bilinear(img.reshape(-1, 3), r0, r1, rows[2][:, None], rows[3][:, None],
                         cols[0], cols[1], cols[2], cols[3])
    return out.to(torch.uint8)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform of a (2, 3) matrix, in f64 as cv2 computes it."""
    m = np.asarray(m, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def invert_perspective(m: np.ndarray) -> np.ndarray:
    """cv2.invert(m, DECOMP_LU) of a (3, 3) matrix, which cv2.warpPerspective takes: the cofactor formula in
    f64 over the determinant by the first row, as cv2 computes a 3x3 inverse; zeros when it is singular."""
    S = np.asarray(m, np.float64)
    det = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
           + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    if det == 0:
        return np.zeros((3, 3))
    d = 1.0 / det
    return np.array([
        [(S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d, (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d,
         (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d],
        [(S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d, (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d,
         (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d],
        [(S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d, (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d,
         (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d]])


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add: exact product and one rounding, through f64."""
    return (a.double() * b.double() + c.double()).float()


def warp_core(pool3: torch.Tensor, base: torch.Tensor, stride: torch.Tensor, ext_h: torch.Tensor,
              ext_w: torch.Tensor, minv: torch.Tensor, out_hw: Tuple[int, int],
              flip_y: Optional[torch.Tensor] = None, flip_x: Optional[torch.Tensor] = None,
              border: int = BORDER) -> torch.Tensor:
    """cv2.warpAffine INTER_LINEAR / BORDER_CONSTANT of N images in a flat (P, 3) uint8 pool, or
    cv2.warpPerspective when `minv` is (N, 3, 3).

    Image n starts at pixel `base[n]`, has rows `stride[n]` pixels apart and
    extent (ext_h[n], ext_w[n]); `minv` (N, 2, 3) or (N, 3, 3) f32 is the inverse matrix.
    flip_y/flip_x (N,) bool mirror the output (np.flipud/fliplr after the warp).
    Returns (N, H, W, 3) uint8.
    """
    dev, (h, w) = pool3.device, out_hw
    n = minv.shape[0]
    xs = torch.arange(w, device=dev).expand(n, w)
    ys = torch.arange(h, device=dev).expand(n, h)
    if flip_x is not None:
        xs = torch.where(flip_x[:, None], w - 1 - xs, xs)
    if flip_y is not None:
        ys = torch.where(flip_y[:, None], h - 1 - ys, ys)
    xs, ys = xs.float()[:, None, :], ys.float()
    m = [minv[:, i // 3, i % 3] for i in range(3 * minv.shape[1])]
    sx = _fma(xs, m[0][:, None, None], (ys * m[1][:, None] + m[2][:, None])[:, :, None])  # (N, H, W)
    sy = _fma(xs, m[3][:, None, None], (ys * m[4][:, None] + m[5][:, None])[:, :, None])
    if len(m) == 9:  # warpPerspective: the source point divided by w in f32
        sw = _fma(xs, m[6][:, None, None], (ys * m[7][:, None] + m[8][:, None])[:, :, None])
        sx, sy = sx / sw, sy / sw
    fx, fy = sx.floor(), sy.floor()
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    big = float(2 ** 24)
    ix, iy = fx.clamp(-2, big).long(), fy.clamp(-2, big).long()
    eh, ew = ext_h.long()[:, None, None], ext_w.long()[:, None, None]
    rowstart, step = base.long()[:, None, None], stride.long()[:, None, None]

    def tap(dy: int, dx: int) -> torch.Tensor:
        yy, xx = iy + dy, ix + dx
        ok = (yy >= 0) & (yy < eh) & (xx >= 0) & (xx < ew)
        idx = rowstart + yy.clamp(min=0) * step + xx.clamp(min=0)
        idx = torch.where(ok, idx, 0)
        p = pool3.index_select(0, idx.reshape(-1)).view(*idx.shape, 3).float()
        return torch.where(ok[..., None], p, float(border))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    p = _fma(a, p01 - p00, p00)
    q = _fma(a, p11 - p10, p10)
    r = _fma(b, q - p, p)
    return r.round_().clamp_(0, 255).to(torch.uint8)


def warp_affine(img: torch.Tensor, m, dsize: Tuple[int, int], border: int = BORDER) -> torch.Tensor:
    """cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3) of (N, h, w, 3) uint8 frames;
    m: one (2, 3) matrix or one per frame (N, 2, 3); dsize is (width, height)."""
    n, h0, w0, _ = img.shape
    m = np.broadcast_to(np.asarray(m, np.float64), (n, 2, 3))
    minv = torch.from_numpy(np.stack([invert_affine(mi) for mi in m]).astype(np.float32)).to(img.device)
    const = lambda v: torch.full((n,), v, device=img.device)  # noqa: E731
    base = torch.arange(n, device=img.device) * (h0 * w0)
    return warp_core(img.reshape(-1, 3), base, const(w0), const(h0), const(w0), minv, (dsize[1], dsize[0]),
                     border=border)


def warp_perspective(img: torch.Tensor, m, dsize: Tuple[int, int], border: int = BORDER) -> torch.Tensor:
    """cv2.warpPerspective(img, m, dsize, borderValue=(border,) * 3) of (N, h, w, 3) uint8 frames;
    m: one (3, 3) matrix or one per frame (N, 3, 3); dsize is (width, height)."""
    n, h0, w0, _ = img.shape
    m = np.broadcast_to(np.asarray(m, np.float64), (n, 3, 3))
    minv = torch.from_numpy(np.stack([invert_perspective(mi) for mi in m]).astype(np.float32)).to(img.device)
    const = lambda v: torch.full((n,), v, device=img.device)  # noqa: E731
    base = torch.arange(n, device=img.device) * (h0 * w0)
    return warp_core(img.reshape(-1, 3), base, const(w0), const(h0), const(w0), minv, (dsize[1], dsize[0]),
                     border=border)


def bgr2hsv(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_BGR2HSV) of uint8 (..., 3): H in [0, 180), S, V in [0, 255]."""
    x = img.int()
    b, g, r = x.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    sdiv, hdiv = (torch.from_numpy(t).to(img.device) for t in (_SDIV, _HDIV))
    s = (diff * sdiv[v.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    hn = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (hn * hdiv[diff.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


def hsv2bgr(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(img, COLOR_HSV2BGR) of uint8 (..., 3), H in [0, 180): f32 as cv2's
    vectorised path computes it (fused multiply-adds in two of the four terms), truncated."""
    x = img.float()
    h = x[..., 0] * np.float32(6 / 180)
    s = x[..., 1] * np.float32(1 / 255)
    v = x[..., 2] * np.float32(1 / 255)
    sector = h.floor()
    hf = h - sector
    sector = sector.long()
    bad = (sector < 0) | (sector >= 6)
    sector, hf = torch.where(bad, 0, sector), torch.where(bad, 0.0, hf)
    one = torch.ones_like(s)
    tab = torch.stack([v, v * (1 - s), v * _fma(-s, hf, one), v * _fma(-s, 1 - hf, one)], -1)
    out = tab.gather(-1, torch.from_numpy(_SECTOR).to(img.device)[sector])
    return (out * np.float32(255)).floor_().clamp_(0, 255).to(torch.uint8)


def lut(img: torch.Tensor, table: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    """cv2.LUT per channel: img (N, ..., 3) uint8; table (256,), (3, 256) or one
    (3, 256) per image (N, 3, 256), uint8."""
    t = torch.as_tensor(table, device=img.device).to(torch.uint8)
    n = img.shape[0]
    t = t.expand(3, 256) if t.dim() == 1 else t
    t = t.expand(n, 3, 256) if t.dim() == 2 else t
    off = (torch.arange(n, device=img.device) * 768).view(n, *([1] * (img.dim() - 1)))
    idx = img.long() + off + torch.arange(3, device=img.device) * 256
    return t.reshape(-1)[idx]


def blend(a: torch.Tensor, b: torch.Tensor, r: Union[float, Sequence[float], torch.Tensor]) -> torch.Tensor:
    """Mixup's (a * r + b * (1 - r)).astype(uint8), in f32 as numpy computes it from a
    Python float; r is one ratio or one per image (N,)."""
    r64 = torch.as_tensor(r, dtype=torch.float64)
    shape = (-1,) + (1,) * (a.dim() - 1) if r64.dim() else ()
    ra = r64.float().to(a.device).view(shape)
    rb = (1 - r64).float().to(a.device).view(shape)
    return (a.float() * ra + b.float() * rb).to(torch.uint8)


def _hull(pts: np.ndarray) -> List[int]:
    """cv2.convexHull(pts, clockwise=False, returnPoints=False) of a few (k, 2) f32 points: the hull's
    vertices (no collinear ones) in cv2's turning direction, from the last point in (x, y) order, then
    shifted to start at the least index when the indices run up cyclically (at the largest when they run
    down), as cv2 shifts them."""
    order = sorted(range(len(pts)), key=lambda i: (pts[i, 0], pts[i, 1]))
    p = pts.astype(np.float64)

    def turn(o, a, b):
        return (p[a, 0] - p[o, 0]) * (p[b, 1] - p[o, 1]) - (p[a, 1] - p[o, 1]) * (p[b, 0] - p[o, 0])

    lower: List[int] = []
    upper: List[int] = []
    for chain, seq in ((lower, order), (upper, order[::-1])):
        for i in seq:
            while len(chain) >= 2 and turn(chain[-2], chain[-1], i) <= 0:
                chain.pop()
            chain.append(i)
    hull = lower[:-1] + upper[:-1] or lower[:1]
    k = hull.index(max(hull, key=lambda i: (pts[i, 0], pts[i, 1])))
    hull = hull[k:] + hull[:k]
    n = len(hull)
    if n < 3:
        return hull
    lo = hi = rises = 0
    for i in range(1, n):
        rises += hull[i - 1] < hull[i]
        if 1 < rises <= i - 2:
            break
        lo = i if hull[i] < hull[lo] else lo
        hi = i if hull[i] > hull[hi] else hi
    if abs(hi - lo) in (1, n - 1) and (rises <= 1 or rises >= n - 2):
        up = (hi + 1) % n == lo
        i0 = lo if up else hi
        shifted = hull[i0:] + hull[:i0]
        if all((a < b) == up for a, b in zip(shifted, shifted[1:])):
            hull = shifted
    return hull


def _calipers(P: np.ndarray):
    """cv2's rotating calipers (CALIPERS_MINAREARECT) over N hulls of n points each, (N, n, 2) f32 in cv2's
    order: the rectangle's corner and its two edge vectors, each (N, 2) f32. The leading edge is chosen as
    OpenCV 5.0 chooses it (rotcalipers.cpp): the four calipers' edge vectors, un-normalised, are turned into
    the first caliper's frame (v0, rot90CW(v1), rot180(v2), rot90CCW(v3)), which is exact, and edge i takes
    over from the one held so far when `firstVecIsRight`: rot90CW(v_i) . v_main < 0, each product rounded to
    f32 before the sum. The strict test keeps the first of parallel edges. The rest is f32."""
    f32, f64 = np.float32, np.float64
    N, n = P.shape[:2]
    rows = np.arange(N)
    x, y = P[..., 0], P[..., 1]
    vx, vy = np.roll(x, -1, 1) - x, np.roll(y, -1, 1) - y  # f32 differences
    inv = (1.0 / np.sqrt(vx.astype(f64) ** 2 + vy.astype(f64) ** 2)).astype(f32)
    ax, ay = np.roll(vx, 1, 1).astype(f64), np.roll(vy, 1, 1).astype(f64)
    convexity = ax * vy - ay * vx
    first = np.argmax(convexity != 0, axis=1)
    base_a = np.where(convexity[rows, first] > 0, f32(1), f32(-1)).astype(f32)
    base_b = np.zeros(N, f32)
    seq = np.stack([y.argmin(1), x.argmax(1), y.argmax(1), x.argmin(1)], 1)  # bottom, right, top, left
    minarea = np.full(N, np.finfo(f32).max, f32)
    best = [np.zeros(N, np.int64), np.zeros(N, f32), np.zeros(N, f32), np.zeros(N, f32), np.zeros(N, f32),
            np.zeros(N, np.int64)]

    def at(a, j):
        return a[rows, seq[:, j]]

    for _ in range(n):
        # the calipers' edges turned into the first caliper's frame: v0, rot90CW(v1), rot180(v2), rot90CCW(v3)
        rot = [(at(vx, 0), at(vy, 0)), (at(vy, 1), -at(vx, 1)), (-at(vx, 2), -at(vy, 2)), (-at(vy, 3), at(vx, 3))]
        main = np.zeros(N, np.int64)
        mx, my = rot[0]
        for i in (1, 2, 3):
            rx, ry = rot[i]
            right = ry * mx - rx * my < 0  # firstVecIsRight(rot[i], rot[main]) in f32
            main = np.where(right, i, main)
            mx, my = np.where(right, rx, mx), np.where(right, ry, my)
        lead = seq[rows, main]
        lx, ly = vx[rows, lead] * inv[rows, lead], vy[rows, lead] * inv[rows, lead]
        base_a = np.choose(main, [lx, ly, -lx, -ly]).astype(f32)
        base_b = np.choose(main, [ly, -lx, -ly, lx]).astype(f32)
        seq[rows, main] = (seq[rows, main] + 1) % n
        width = (at(x, 1) - at(x, 3)) * base_a + (at(y, 1) - at(y, 3)) * base_b
        height = -(at(x, 2) - at(x, 0)) * base_b + (at(y, 2) - at(y, 0)) * base_a
        area = width * height
        take = area <= minarea  # the last of equal areas
        minarea = np.where(take, area, minarea)
        for slot, val in enumerate((seq[:, 3], base_a, width, base_b, height, seq[:, 0])):
            best[slot] = np.where(take, val, best[slot])
    left, a1, width, b1, height, bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * x[rows, left] + y[rows, left] * b1
    c2 = a2 * x[rows, bottom] + y[rows, bottom] * b2
    idet = f32(1) / (a1 * b2 - a2 * b1)
    corner = np.stack([(c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet], -1)
    return corner, np.stack([a1 * width, b1 * width], -1), np.stack([a2 * height, b2 * height], -1)


def min_area_rect(points: np.ndarray) -> np.ndarray:
    """cv2.minAreaRect (OpenCV 5.0) of each point set: points (..., k, 2) -> (..., 5) f32 rows
    [cx, cy, w, h, angle in degrees], the angle in [-90, 0) and w the side along it. Held to cv2 in
    tests/test_torch_obb_data.py: seeded quads, and rectangles rounded to whole pixels, bit for bit (where two
    near-parallel sides give areas equal to f32 rounding, cv2's caliper test decides, as `_calipers` reproduces
    it). A set on one line is a zero-height rectangle along it, one point a zero rectangle at -90."""
    pts = np.asarray(points, np.float32)
    flat = pts.reshape(-1, *pts.shape[-2:])
    out = np.zeros((len(flat), 5), np.float32)
    hulls = [_hull(p) for p in flat]
    for n in sorted({len(h) for h in hulls}):
        idx = np.array([i for i, h in enumerate(hulls) if len(h) == n])
        P = np.stack([flat[i][hulls[i]] for i in idx])
        if n >= 3:
            corner, e1, e2 = _calipers(P)
            centre = corner + (e1 + e2) * np.float32(0.5)
            s1 = np.sqrt((e1.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
            s2 = np.sqrt((e2.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
            ang = ((np.arctan2(e1[:, 1].astype(np.float64), e1[:, 0].astype(np.float64)) - math.pi / 2)
                   * 180 / math.pi).astype(np.float32)
            up = ang >= 0  # e1 straight up: -90 with w along e1; otherwise w along e2
            out[idx] = np.stack([centre[:, 0], centre[:, 1], np.where(up, s1, s2), np.where(up, s2, s1),
                                 np.where(up, ang - 90, ang)], -1)
        else:  # a segment (or one point): its direction folded into [-90, 0)
            d = (P[:, -1] - P[:, 0]).astype(np.float64)
            length = np.sqrt((d ** 2).sum(-1)).astype(np.float32)
            deg = np.degrees(np.arctan2(d[:, 1], d[:, 0]))
            deg = np.where(deg >= 90, deg - 180, np.where(deg < -90, deg + 180, deg))
            along = (deg < 0) | (length == 0)
            centre = (P[:, 0] + P[:, -1]) * np.float32(0.5)
            out[idx] = np.stack([centre[:, 0], centre[:, 1], np.where(along, length, 0), np.where(along, 0, length),
                                 np.where(length == 0, -90.0, np.where(along, deg, deg - 90))], -1)
    return out.reshape(pts.shape[:-2] + (5,))


# -- cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) and cv2.contourArea ----------------------------

_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)  # cv2's chain code s -> step: 0 right, 2 up, 4 left, 6 down
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126  # cv2's mark of a border pixel whose right neighbour is background (nbd 2 | -128)


def _follow_outer_border(img, i0: int, step: int, x: int, y: int) -> List[Tuple[int, int]]:
    """cv2's `icvFetchContour` of an outer border from flat index i0 (frame pixel (x, y)) of the padded
    signed-byte image `img` (a memoryview), marking its pixels 2 or `_RIGHT_BOUND` as cv2 marks them:
    the points where the chain code turns (CHAIN_APPROX_SIMPLE), from the start pixel on."""
    deltas = (1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1) * 2
    s = s_end = 4
    while True:  # the first neighbour clockwise from up-left
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a lone pixel
        img[i0] = _RIGHT_BOUND
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:  # the next neighbour counter-clockwise
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            img[i3] = _RIGHT_BOUND
        elif img[i3] == 1:
            img[i3] = 2
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0] of an (H, W) mask (nonzero is
    foreground), without OpenCV: a list of (K, 1, 2) int32 (x, y) contours, point for point and in cv2's
    order. Suzuki and Abe's border following as cv2 runs it: the mask padded by one zero pixel, a raster scan
    that starts an outer border at a 0 -> 1 step whose last marked pixel on the row is not inside a traced
    component, 8-connected borders traced counter-clockwise from the first pixel and marked, straight runs
    kept by their ends; holes and whatever lies inside them are skipped, and each contour found is put in
    front of those found before (cv2's list order)."""
    m = np.asarray(mask)
    h, w = m.shape
    pad = np.zeros((h + 2, w + 2), np.int8)
    pad[1:-1, 1:-1] = m != 0
    buf = bytearray(pad.tobytes())
    img = memoryview(buf).cast("b")
    arr = np.frombuffer(buf, np.int8).reshape(h + 2, w + 2)
    step, width = w + 2, w + 1
    contours: List[np.ndarray] = []
    for y in np.flatnonzero(pad.any(1)).tolist():
        row = arr[y]
        x, prev, lnbd = 1, 0, 0
        while x < width:
            nxt = np.flatnonzero(row[x:width] != prev)  # cv2's fast skip to the next change of value
            if not len(nxt):
                break
            x += int(nxt[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:  # an outer border, not inside a traced component
                pts = _follow_outer_border(img, y * step + x, step, x - 1, y - 1)
                contours.append(np.asarray(pts, np.int32).reshape(-1, 1, 2))
                prev = int(row[x])
            else:
                prev = p
                if p & -2:  # a marked border pixel: the last one seen on this row
                    lnbd = x
            x += 1
    return contours[::-1]


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea of an integer or float contour (K, 1, 2) or (K, 2): the shoelace sum in f64 from the
    last point around, halved, its absolute value."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float32).astype(np.float64)
    q = np.roll(p, 1, 0)
    a = 0.0
    for (px, py), (x, y) in zip(q.tolist(), p.tolist()):
        a += px * y - py * x
    return abs(a * 0.5)
