"""The v8 Detect, WorldDetect, Segment, Pose, OBB, Classify and v10Detect heads, the NMS-free top-k decode, the v8 decode,
the keypoint decode and the rotated decode (NCHW).

Counterpart of `lpc_yolo_tpu/nn/heads.py` (`_v8_towers` :52-77, Detect
:80-92, WorldDetect :542-580, Segment :95-119, Pose :122-154, decode_kpts :157-176, OBB :178-204, dist2rbox :207-216, Classify :219-233;
V10Detect :234, plain branch :309-335; decode_feats_topk_split :401-496, unpacked case;
decode_feats_obb :499-518; decode_feats :521). The segmented TPU top-k
(`heads._topk`) becomes `torch.topk`. Both heads return per-level
(box_map, cls_map) pairs where the JAX heads concatenate the two on the
channel axis; the losses and the decodes take the pairs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.anchors import Grid, dfl_expectation, dist2bbox, make_anchors, make_grid
from ..ops.boxes import xywh2xyxy
from .modules import BNContrastiveHead, ContrastiveHead, ConvBN, Proto


def _box_tower(ci: int, c2: int, reg_max: int) -> nn.Sequential:
    return nn.Sequential(ConvBN(ci, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))


def _v8_cls_tower(ci: int, c3: int, nc: int) -> nn.Sequential:
    return nn.Sequential(ConvBN(ci, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, nc, 1))


@torch.no_grad()
def _init_biases(boxes, clss, strides, nc: int) -> None:
    """Box bias 1.0, cls bias log(5 / nc / (640 / stride)^2) (head.py:88-95, 527-535)."""
    for box, cls, s in zip(boxes, clss, strides):
        box[-1].bias.fill_(1.0)
        cls[-1].bias.fill_(math.log(5 / nc / (640 / s) ** 2))


class Detect(nn.Module):
    """YOLOv8 anchor-free decoupled head (reference head.py:21-101; JAX `_v8_towers`).

    Per level a box tower (3x3 ConvBN, 3x3 ConvBN, 1x1 conv to 4*reg_max) and a
    cls tower (3x3 ConvBN, 3x3 ConvBN, 1x1 conv to nc). `forward` returns the
    per-level (box_map (B, 4*reg_max, H, W), cls_map (B, nc, H, W)) pairs.
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), strides=(8.0, 16.0, 32.0), reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_tower(c, c2, reg_max) for c in ch)
        self.cv3 = nn.ModuleList(_v8_cls_tower(c, c3, nc) for c in ch)
        _init_biases(self.cv2, self.cv3, self.strides, nc)

    def forward(self, xs: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(self.cv2[i](x), self.cv3[i](x)) for i, x in enumerate(xs)]


class WorldDetect(nn.Module):
    """YOLO-World's open-vocabulary head (JAX `nn/heads.py:542-580`; reference head.py:224-264): per level the v8 box
    tower (`cv2`), an embedding tower (`cv3`: 3x3 ConvBN, 3x3 ConvBN, 1x1 biased conv to `embed` channels) and a
    contrastive head (`cv4`: `BNContrastiveHead` when `with_bn`, else `ContrastiveHead`) against the text (B, M,
    embed). c3 = max(ch[0], min(nc, 100)) takes the YAML's nc; the class maps have the text's M channels. `forward`
    returns the per-level (box_map, cls_map (B, M, H, W) f32) pairs that `Detect` returns."""

    def __init__(self, nc: int = 80, embed: int = 512, with_bn: bool = False, ch: Sequence[int] = (),
                 strides=(8.0, 16.0, 32.0), reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(_box_tower(c, c2, reg_max) for c in ch)
        self.cv3 = nn.ModuleList(_v8_cls_tower(c, c3, embed) for c in ch)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead() for _ in ch)
        with torch.no_grad():
            for box in self.cv2:  # the box bias 1.0, as in Detect
                box[-1].bias.fill_(1.0)

    def forward(self, xs: Sequence[torch.Tensor], text: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(self.cv2[i](x), self.cv4[i](self.cv3[i](x), text)) for i, x in enumerate(xs)]


class Segment(Detect):
    """YOLOv8 Segment head (reference head.py:104-128): the Detect towers, a mask-coefficient tower
    per level (cv4: 3x3 ConvBN, 3x3 ConvBN, 1x1 conv to nm, c4 = max(ch[0] // 4, nm)) and `Proto`
    on P3. `forward` returns (the Detect pairs, mc (B, A, nm) over the levels in the anchor order,
    proto (B, nm, 2 H3, 2 W3)); the JAX head gives proto NHWC."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: Sequence[int] = (),
                 strides=(8.0, 16.0, 32.0), reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, nm, 1)) for c in ch)

    def forward(self, xs: Sequence[torch.Tensor]):
        proto = self.proto(xs[0])
        mc = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2)
        return super().forward(xs), mc, proto


class Pose(Detect):
    """YOLOv8 Pose head (reference head.py:161-200): the Detect towers and a keypoint tower per level
    (cv4: 3x3 ConvBN, 3x3 ConvBN, 1x1 conv to nk = K * ndim, c4 = max(ch[0] // 4, nk)). `forward`
    returns (the Detect pairs, the raw keypoints (B, A, nk) over the levels in the anchor order);
    `decode_kpts` decodes them."""

    def __init__(self, nc: int = 1, kpt_shape: Tuple[int, int] = (17, 3), ch: Sequence[int] = (),
                 strides=(8.0, 16.0, 32.0), reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        c4 = max(ch[0] // 4, nk)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, nk, 1)) for c in ch)

    def forward(self, xs: Sequence[torch.Tensor]):
        kpt = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2)
        return super().forward(xs), kpt


def decode_kpts(kpt: torch.Tensor, feat_shapes, strides: Sequence[float],
                kpt_shape: Tuple[int, int] = (17, 3), grid: Optional[Grid] = None) -> torch.Tensor:
    """Raw keypoints (B, A, nk) -> (B, A, nk) f32 (head.py:185-200): xy = (raw * 2 + anchor - 0.5) * stride
    in input pixels, and with ndim 3 the visibility through a sigmoid. `grid`: the anchors, made here when it is
    not given (as in every decode below)."""
    anchor_points, stride_tensor = grid[:2] if grid is not None else make_anchors(feat_shapes, strides, 0.5,
                                                                                  device=kpt.device)
    B, A, nk = kpt.shape
    y = kpt.reshape(B, A, *kpt_shape).float()
    xy = (y[..., :2] * 2.0 + (anchor_points[None, :, None] - 0.5)) * stride_tensor[None, :, None]
    if kpt_shape[1] == 3:
        xy = torch.cat([xy, y[..., 2:3].sigmoid()], -1)
    return xy.reshape(B, A, nk)


class OBB(Detect):
    """YOLOv8 oriented-box head (reference head.py:130-159): the Detect towers and an angle tower per level
    (cv4: 3x3 ConvBN, 3x3 ConvBN, 1x1 conv to ne, c4 = max(ch[0] // 4, ne)). `forward` returns (the Detect
    pairs, the angle (B, A, ne) f32 over the levels in the anchor order, mapped to [-pi/4, 3 pi/4] by
    (sigmoid - 0.25) * pi in f32)."""

    def __init__(self, nc: int = 15, ne: int = 1, ch: Sequence[int] = (), strides=(8.0, 16.0, 32.0),
                 reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(nn.Sequential(ConvBN(c, c4, 3), ConvBN(c4, c4, 3), nn.Conv2d(c4, ne, 1)) for c in ch)

    def forward(self, xs: Sequence[torch.Tensor]):
        angle = torch.cat([self.cv4[i](x).flatten(2) for i, x in enumerate(xs)], 2).transpose(1, 2).float()
        return super().forward(xs), (angle.sigmoid() - 0.25) * math.pi


def dist2rbox(pred_dist: torch.Tensor, angle: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """Rotated decode (reference tal.py:329-345): the (l, t, r, b) midpoint offset rotated by the angle about
    the anchor -> (..., 4) [cx, cy, w, h]."""
    lt, rb = pred_dist.chunk(2, -1)
    cos, sin = torch.cos(angle), torch.sin(angle)
    xf, yf = ((rb - lt) / 2).chunk(2, -1)
    x = xf * cos - yf * sin
    y = xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


def decode_feats_obb(feats: Sequence[Tuple[torch.Tensor, torch.Tensor]], angle: torch.Tensor,
                     strides: Sequence[float], nc: int, reg_max: int = 16, grid: Optional[Grid] = None) -> torch.Tensor:
    """Per-level (box, cls) maps and the angle (B, A, 1) in radians -> (B, A, 4 + nc + 1) f32 = [cx, cy, w, h
    (the rotated box in input pixels), sigmoid class scores, angle] (`OBB.decode_bboxes`)."""
    box = torch.cat([bm.flatten(2) for bm, _ in feats], 2).transpose(1, 2).float()
    cls = torch.cat([cm.flatten(2) for _, cm in feats], 2).transpose(1, 2).float()
    if grid is None:
        grid = make_grid([(cm.shape[2], cm.shape[3]) for _, cm in feats], strides, reg_max, box.device)
    rbox = dist2rbox(dfl_expectation(box, reg_max, grid.bins), angle, grid.points) * grid.strides
    return torch.cat([rbox, cls.sigmoid(), angle], -1)


def _cls_tower(ci: int, c3: int, nc: int) -> nn.Sequential:
    # lightweight cls tower: (DW3x3 -> 1x1) x2 -> 1x1 (reference head.py:503-506)
    return nn.Sequential(
        nn.Sequential(ConvBN(ci, ci, 3, g=ci), ConvBN(ci, c3, 1)),
        nn.Sequential(ConvBN(c3, c3, 3, g=c3), ConvBN(c3, c3, 1)),
        nn.Conv2d(c3, nc, 1),
    )



class Classify(nn.Module):
    """The YOLOv8 classification head (JAX `nn/heads.py:219-233`; reference head.py:202-222): a 1x1
    ConvBN (SiLU) to c_ channels, the mean over H and W, a Linear to nc. Returns the logits (B, nc). The
    mean is taken in f32 whatever the map's dtype (a 1280-channel 7x7 map in bf16 on the card), and the
    logits come back in the map's dtype."""

    def __init__(self, c1: int, nc: int = 1000, c_: int = 1280):
        super().__init__()
        self.conv = ConvBN(c1, c_, 1, 1)
        self.linear = nn.Linear(c_, nc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.linear(x.mean((2, 3), dtype=torch.float32).to(x.dtype))

class V10Detect(nn.Module):
    """YOLOv10 dual-assignment head (reference head.py:497-535).

    `cv2`/`cv3` are the one-to-many towers, `one2one_cv2`/`one2one_cv3` the
    structurally identical one-to-one towers. Serving runs one2one only; both
    branches' modules exist (they are part of the parameter count). Each
    branch returns per-level (box_map (B, 4*reg_max, H, W), cls_map (B, nc, H, W)).
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), strides=(8.0, 16.0, 32.0), reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        for prefix in ("", "one2one_"):
            setattr(self, f"{prefix}cv2", nn.ModuleList(_box_tower(c, c2, reg_max) for c in ch))
            setattr(self, f"{prefix}cv3", nn.ModuleList(_cls_tower(c, c3, nc) for c in ch))
        for prefix in ("", "one2one_"):
            _init_biases(getattr(self, f"{prefix}cv2"), getattr(self, f"{prefix}cv3"), self.strides, nc)

    def branch(self, xs: Sequence[torch.Tensor], name: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        prefix = "one2one_" if name == "one2one" else ""
        box, cls = getattr(self, f"{prefix}cv2"), getattr(self, f"{prefix}cv3")
        return [(box[i](x), cls[i](x)) for i, x in enumerate(xs)]

    def forward(self, xs: Sequence[torch.Tensor], branches: str = "both") -> Dict[str, list]:
        out = {}
        if branches in ("both", "one2one"):
            # the one-to-one branch trains on detached features (JAX stop_gradient)
            out["one2one"] = self.branch([x.detach() for x in xs], "one2one")
        if branches in ("both", "one2many"):
            out["one2many"] = self.branch(xs, "one2many")
        return out


def decode_feats_topk_split(
    pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    strides: Sequence[float],
    nc: int,
    reg_max: int = 16,
    max_det: int = 300,
) -> torch.Tensor:
    """NMS-free v10 decode over per-level (box_map, cls_map) pairs: top-k on the
    raw class logits first (sigmoid is monotonic), DFL and sigmoid only on the
    survivors, then a flattened (anchor, class) top-k.

    Returns (B, max_det, 6) = [x1, y1, x2, y2, score, label] in f32.
    """
    B = pairs[0][0].shape[0]
    feat_shapes = [(cm.shape[2], cm.shape[3]) for _, cm in pairs]
    A = sum(h * w for h, w in feat_shapes)
    k1 = min(max_det, A)
    max_logit = torch.cat([cm.amax(1).reshape(B, -1) for _, cm in pairs], 1).float()  # (B, A)
    idx = max_logit.topk(k1, dim=1).indices  # (B, k1)
    box = torch.cat([bm.flatten(2) for bm, _ in pairs], 2)  # (B, 4*reg_max, A)
    cls = torch.cat([cm.flatten(2) for _, cm in pairs], 2)  # (B, nc, A)
    sel_box = box.gather(2, idx[:, None].expand(B, box.shape[1], k1)).transpose(1, 2).float()
    sel_cls = cls.gather(2, idx[:, None].expand(B, nc, k1)).transpose(1, 2).float()

    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=idx.device)
    sel_anchors = anchor_points[idx]  # (B, k1, 2)
    sel_strides = stride_tensor[idx]  # (B, k1, 1)
    dbox = dist2bbox(dfl_expectation(sel_box, reg_max), sel_anchors, xywh=True) * sel_strides
    scores = sel_cls.sigmoid().reshape(B, -1)

    k2 = min(max_det, scores.shape[1])
    out_scores, fidx = scores.topk(k2, dim=1)
    labels = fidx % nc
    out_boxes = dbox.gather(1, (fidx // nc)[..., None].expand(B, k2, 4))
    det = torch.cat([xywh2xyxy(out_boxes), out_scores[..., None], labels[..., None].float()], -1)
    if k2 < max_det:
        det = torch.cat([det, det.new_zeros(B, max_det - k2, 6)], 1)
    return det


def decode_feats(feats: Sequence, strides: Sequence[float], nc: int, reg_max: int = 16,
                 grid: Optional[Grid] = None) -> torch.Tensor:
    """Raw per-level (B, 4*reg_max + nc, H, W) maps, or per-level (box_map, cls_map) pairs,
    -> (B, A, 4 + nc) = [xywh px, sigmoid cls] in f32."""
    feats = [torch.cat(f, 1) if isinstance(f, (tuple, list)) else f for f in feats]
    flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2).float()  # (B, A, no)
    if grid is None:
        grid = make_grid([(f.shape[2], f.shape[3]) for f in feats], strides, reg_max, flat.device)
    dbox = dist2bbox(dfl_expectation(flat[..., : 4 * reg_max], reg_max, grid.bins), grid.points, xywh=True)
    dbox = dbox * grid.strides
    return torch.cat([dbox, flat[..., 4 * reg_max:].sigmoid()], -1)
