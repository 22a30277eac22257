"""ReID appearance encoders of BoT-SORT (counterpart of `lpc_yolo_tpu/trackers/reid.py:27-129`).

Both are callables `encoder(frame_bgr, boxes_xyxy) -> (N, D) f32` unit rows,
over the boxes' crops resized to 128x64 (`_crop_resize`: the box clipped to
the frame and cut to whole pixels, then cv2.resize INTER_LINEAR bit for bit
through `data/cvops.py`'s taps and fixed-point bilinear, on the host for the
histogram and on the encoder's device for the CNN). Neither needs OpenCV.

* `HistogramEncoder` (`hist`): the crop's HSV (`cvops.bgr2hsv`, cv2's
  integer path) binned 8 x 8 x 4 over [0, 180) x [0, 256) x [0, 256) as
  cv2.calcHist bins uint8 values (`hist_bins`: floor(v * bins / range) in
  f64, so the bin edges fall where cv2's do), 256-d, L2-normalised. Host.
* `CNNEncoder` (`cnn`): `ReIDNet`, four stride-2 3x3 convs (32, 64, 128,
  128) each with GroupNorm(8) and ReLU, the spatial mean, a Linear to 128,
  then L2-normalised; one batch of every crop a frame, on the card unless
  `device="cpu"`. flax's SAME padding at stride 2 pads (0, 1) on an even
  side and (1, 1) on an odd one, so each conv pads explicitly; flax's
  GroupNorm epsilon is 1e-6. The JAX encoder's parameters (its
  `PRNGKey(42)` init, or any tree of the same names) come in through
  `params=` (flax variables) or `params_path=` (an `.npz` keyed by the JAX
  `/`-joined names, `utils/flax_bridge.py::variables_from_flat`); without
  them the weights are `random_variables` of seed 42, the port's own.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.cvops import bgr2hsv, fixed_bilinear, resize_taps
from ..utils import resolve_device
from ..utils.flax_bridge import flax_shapes, flax_to_state_dict, random_variables, variables_from_flat

CROP_H, CROP_W = 128, 64
HIST_BINS = (8, 8, 4)
HIST_RANGES = ((0, 180), (0, 256), (0, 256))
REID_SEED = 42  # the CNN's own weights without parameters given (the JAX encoder inits from PRNGKey(42))


def _crop_resize(img: np.ndarray, boxes: np.ndarray, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(N, CROP_H, CROP_W, 3) uint8 crops of xyxy boxes from an HWC uint8 BGR frame, on `device`: each box
    clipped to the frame and cut to whole pixels (at least one), resized as cv2.resize INTER_LINEAR. Every
    crop in one `fixed_bilinear` over the frame's pixels, each with its own taps."""
    h, w = img.shape[:2]
    taps = [[] for _ in range(8)]  # r0, r1, b0, b1 (rows); c0, c1, a0, a1 (columns)
    for x1, y1, x2, y2 in boxes[:, :4]:
        x1 = int(max(0, min(w - 1, x1)))
        x2 = int(max(x1 + 1, min(w, x2)))
        y1 = int(max(0, min(h - 1, y1)))
        y2 = int(max(y1 + 1, min(h, y2)))
        rows, cols = resize_taps((y2 - y1, x2 - x1), (CROP_H, CROP_W))
        for t, v in zip(taps, ((y1 + rows[0]) * w, (y1 + rows[1]) * w, rows[2], rows[3],
                               x1 + cols[0], x1 + cols[1], cols[2], cols[3])):
            t.append(v)
    t = [torch.from_numpy(np.stack(v)).to(device) for v in taps]
    pool = torch.from_numpy(np.ascontiguousarray(img)).to(device).reshape(-1, 3)
    out = fixed_bilinear(pool, *(v[:, :, None] for v in t[:4]), *(v[:, None, :] for v in t[4:]))
    return out.to(torch.uint8)


def hist_bins(bins: int, lo: float, hi: float) -> np.ndarray:
    """cv2.calcHist's bin of each uint8 value 0..255 along one channel of uniform range [lo, hi): the
    floor of v * t - lo * t with t = bins / (hi - lo) in f64, clamped into [0, bins); -1 outside the
    range."""
    t = bins / (float(hi) - float(lo))
    v = np.arange(256, dtype=np.float64)
    idx = np.clip(np.floor(v * t + (-t * float(lo))), 0, bins - 1).astype(np.int64)
    return np.where((v >= lo) & (v < hi), idx, -1)


class HistogramEncoder:
    """HSV colour-histogram embedding, 8 H x 8 S x 4 V = 256-d, of each box's crop."""

    def __init__(self, bins=HIST_BINS):
        self.bins = tuple(bins)
        self.tables = [hist_bins(b, *r) for b, r in zip(self.bins, HIST_RANGES)]

    def __call__(self, img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros((0, int(np.prod(self.bins))), np.float32)
        crops = _crop_resize(img, np.asarray(boxes))
        hsv = bgr2hsv(crops).numpy().astype(np.int64)
        idx = [t[hsv[..., c]] for c, t in enumerate(self.tables)]
        nb = int(np.prod(self.bins))
        flat = (idx[0] * self.bins[1] + idx[1]) * self.bins[2] + idx[2] + nb * np.arange(len(crops))[:, None, None]
        valid = (idx[0] >= 0) & (idx[1] >= 0) & (idx[2] >= 0)
        hists = np.bincount(flat[valid], minlength=nb * len(crops)).reshape(len(crops), nb).astype(np.float32)
        return np.stack([f / (np.linalg.norm(f) + 1e-12) for f in hists])


def _same_pad(n: int, k: int = 3, s: int = 2):
    """flax's SAME padding of one side of n pixels for a k-tap stride-s conv: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ReIDNet(nn.Module):
    """The JAX encoder's `_Net` (:96-105): NCHW f32 in [0, 1] -> (N, dim) embeddings (not normalised)."""

    def __init__(self, dim: int = 128, widths=(32, 64, 128, 128)):
        super().__init__()
        cin = 3
        for i, c in enumerate(widths):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, 3, stride=2))
            setattr(self, f"gn{i}", nn.GroupNorm(8, c, eps=1e-6))
            cin = c
        self.depth = len(widths)
        self.fc = nn.Linear(cin, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            (t, b), (l, r) = _same_pad(x.shape[-2]), _same_pad(x.shape[-1])
            x = getattr(self, f"conv{i}")(F.pad(x, (l, r, t, b)))
            x = F.relu(getattr(self, f"gn{i}")(x))
        return self.fc(x.mean((2, 3)))


class CNNEncoder:
    """The convnet embedder: each box's crop -> a (128,) unit row, every crop of a frame in one batch."""

    def __init__(self, params_path: Optional[str] = None, embed_dim: int = 128,
                 params: Optional[Dict[str, Any]] = None, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.net = ReIDNet(embed_dim)
        variables = params if params is not None else random_variables(flax_shapes(self.net), REID_SEED)
        if params_path:  # the file's leaves over the others, as the JAX encoder loads them
            variables = variables_from_flat(dict(np.load(params_path)), variables)
        self.net.load_state_dict(flax_to_state_dict(variables), strict=True)
        self.net.to(self.device).eval()
        self.dim = embed_dim

    @torch.inference_mode()
    def embed(self, crops: torch.Tensor) -> np.ndarray:
        """(N, CROP_H, CROP_W, 3) uint8 crops -> (N, dim) f32 unit rows on the host."""
        x = crops.to(self.device).permute(0, 3, 1, 2).float() / 255.0
        e = self.net(x)
        return (e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)).cpu().numpy()

    def __call__(self, img: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros((0, self.dim), np.float32)
        return self.embed(_crop_resize(img, np.asarray(boxes), self.device))


def build_encoder(kind: str = "hist", **kw):
    """The encoder a tracker config names (`reid_encoder: hist | cnn`); `kw` goes to CNNEncoder."""
    if kind in ("hist", "histogram"):
        return HistogramEncoder()
    if kind == "cnn":
        return CNNEncoder(**kw)
    raise ValueError(f"unknown reid encoder {kind!r} (use 'hist' or 'cnn')")
