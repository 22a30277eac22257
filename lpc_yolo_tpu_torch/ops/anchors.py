"""Grid anchors, distance <-> box and the DFL expectation (counterpart of
`lpc_yolo_tpu/ops/anchors.py`; reference tal.py:294-345, block.py:42-61)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[float],
    grid_cell_offset: float = 0.5,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(h*w), 2) grid centres in grid units and (sum(h*w), 1) strides, row-major per level."""
    points, strides_out = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        sy, sx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([sx, sy], -1).reshape(-1, 2))
        strides_out.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points), torch.cat(strides_out)


class Grid(NamedTuple):
    """What the decodes compute from a static input shape alone: the grid centres (A, 2), their strides (A, 1)
    and the DFL bins 0 .. reg_max - 1. An export graph holds them as buffers, so a traced artifact carries them as
    tensors that move with it to the device it is loaded on (`engine/exporter.py`)."""
    points: torch.Tensor
    strides: torch.Tensor
    bins: torch.Tensor


def make_grid(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[float], reg_max: int = 16,
              device=None) -> Grid:
    """The f32 `Grid` of a head's levels: `make_anchors` at offset 0.5 and `arange(reg_max)`."""
    points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=device)
    return Grid(points, stride_tensor, torch.arange(reg_max, dtype=torch.float32, device=device))


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True, dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances about anchor points -> xywh or xyxy boxes."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim)
    return torch.cat([x1y1, x2y2], dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances about anchor points, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def dfl_expectation(pred_dist: torch.Tensor, reg_max: int = 16, bins: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax expectation over reg_max bins; channel c = side * reg_max + bin.

    (..., 4 * reg_max) logits -> (..., 4) distances. `bins` are the f32 bins 0 .. reg_max - 1 of a `Grid`, made
    here when it is not given.
    """
    x = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max)
    proj = torch.arange(reg_max, dtype=x.dtype, device=x.device) if bins is None else bins.to(x.dtype)
    return x.softmax(-1) @ proj
