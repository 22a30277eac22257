"""RT-DETR's transformer parts (counterpart of `lpc_yolo_tpu/nn/transformer.py`): AIFI's encoder layer with its
2-D sin-cos position embedding, and the RTDETRDecoder head with multi-scale deformable attention, its serving
branch and its train branch (contrastive denoising, every layer's outputs for the DETR loss).

The JAX package writes the sampler and the attention as XLA ops, not as Pallas
kernels, so here they are PyTorch ops: `F.grid_sample` (bilinear, zero
padding, align_corners=False: the JAX `bilinear_sample`, :48-81) and
`F.scaled_dot_product_attention` (flax's MultiHeadDotProductAttention scales
the query by 1/sqrt(hd), as SDPA does; SDPA picks its backend, and on an
H100 the calls with the denoising group's boolean mask run cuDNN's fused
attention forward and backward).

Names mirror the JAX modules for the weight bridge (`utils/flax_bridge.py`):
a flax Dense is an nn.Linear, `layers_<i>` is `layers.<i>`; flax's attention
keeps its 3-D kernels (`query` / `key` / `value` (C, nh, hd), `out`
(nh, hd, C)) in the JAX layout; flax's LayerNorm has eps 1e-6 (torch's
default is 1e-5); the decoder's BatchNorms are `input_proj.<i>.1`.

Under a bf16 serving copy the numbers follow the JAX package's type
promotion: the reference-box chain (anchors, the box heads' sums,
`inverse_sigmoid`, the sampling locations) stays in f32, the sampler reads the
bf16 values in f32 (as the JAX gather does once its f32 weights multiply
them), LayerNorm keeps f32 statistics, and the softmaxes run in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules import BN_EPS, BN_MOMENTUM, BatchNorm2d

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def box_dtype(weight: torch.Tensor) -> torch.dtype:
    """The dtype of the reference-box chain of a module with this weight: f32, or f64 in an f64 model."""
    return torch.promote_types(weight.dtype, torch.float32)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """log(x / (1 - x)) of x clipped to [eps, 1 - eps] (JAX :25-27)."""
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class MLP(nn.Module):
    """num_layers Linears with ReLU between them (JAX :30-45); `layers.<i>`. An f32 input (a reference box)
    is cast to the layers' dtype, as flax's Dense casts it."""

    def __init__(self, c1: int, hidden: int, c2: int, num_layers: int):
        super().__init__()
        dims = [c1] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [c2]))

    def forward(self, x):
        x = x.to(self.layers[0].weight.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DenseGeneral(nn.Module):
    """One projection of flax's MultiHeadDotProductAttention, its kernel in the JAX layout: (c, nh, hd) into the
    heads, or (nh, hd, c) out of them (`out`); the bias has the output's shape."""

    def __init__(self, kernel_shape: Tuple[int, ...], bias_shape: Tuple[int, ...], fan_in: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_shape))
        self.bias = nn.Parameter(torch.empty(bias_shape))
        bound = 1 / math.sqrt(fan_in)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c_in = x.shape[-1]
        return F.linear(x, self.weight.reshape(c_in, -1).t(), self.bias.reshape(-1))


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention(num_heads=nh, qkv_features=c)` (JAX :180, :332): query, key and value
    projections to nh heads of c // nh, softmax(q k^T / sqrt(hd)) v per head, the out projection. `mask`
    (Lq, Lk) bool, True = may attend (flax's and SDPA's sense)."""

    def __init__(self, c: int, nh: int):
        super().__init__()
        self.nh, self.hd = nh, c // nh
        self.query, self.key, self.value = (DenseGeneral((c, nh, self.hd), (nh, self.hd), c) for _ in range(3))
        self.out = DenseGeneral((nh, self.hd, c), (c,), c)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L = q.shape[:2]
        heads = lambda proj, t: proj(t).view(B, t.shape[1], self.nh, self.hd).transpose(1, 2)  # noqa: E731
        o = F.scaled_dot_product_attention(heads(self.query, q), heads(self.key, k), heads(self.value, v),
                                           attn_mask=mask)
        return self.out(o.transpose(1, 2).reshape(B, L, self.nh * self.hd))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (JAX :316-339): x + attention(x + pos, x + pos, x), LayerNorm, x + fc2(GELU(fc1(x)))
    (exact GELU), LayerNorm."""

    def __init__(self, c: int, cm: int = 2048, nh: int = 8):
        super().__init__()
        self.ma = MultiHeadAttention(c, nh)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.fc1 = nn.Linear(c, cm)
        self.fc2 = nn.Linear(cm, c)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = x + pos
        x = self.norm1(x + self.ma(q, q, x))
        return self.norm2(x + self.fc2(F.gelu(self.fc1(x), approximate="none")))


def sincos_2d_pos_embed(w: int, h: int, dim: int, temperature: float = 10000.0,
                        device=None) -> torch.Tensor:
    """(1, w * h, dim) 2-D sin-cos embedding in f32, built as the JAX one (:342-358) and the reference: the grid
    from meshgrid(arange(w), arange(h), "ij") flattens h fastest while the map's tokens run w fastest. That
    transposed order is the reference's; on a non-square map it matters, so it is kept."""
    if dim % 4:
        raise ValueError(f"the sin-cos embedding needs dim divisible by 4, not {dim}")
    grid_w, grid_h = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                                    torch.arange(h, dtype=torch.float32, device=device), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim)
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class AIFI(nn.Module):
    """Attention-based intra-scale feature interaction (JAX :361-381): the map's h * w tokens (h-major, as the JAX
    NHWC reshape) plus the sin-cos embedding through one TransformerEncoderLayer (`enc`), back to the map. On a
    channels_last map the tokens are a view and so is the result."""

    def __init__(self, c1: int, cm: int = 2048, nh: int = 8):
        super().__init__()
        self.enc = TransformerEncoderLayer(c1, cm, nh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        pos = sincos_2d_pos_embed(W, H, C, device=x.device).to(x.dtype)
        y = self.enc(x.flatten(2).transpose(1, 2), pos)
        return y.transpose(1, 2).unflatten(2, (H, W))


def multi_scale_deformable_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], locations: torch.Tensor,
                                weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention (JAX :84-110; reference utils.py multi_scale_deformable_attn_pytorch).

    value (B, len_v, nh, hd), each level's h * w tokens in turn; locations (B, len_q, nh, nl, np, 2) as (x, y) in
    [0, 1]; weights (B, len_q, nh, nl, np). Each level's values are sampled bilinearly at `2 * loc - 1` with zero
    padding and align_corners=False (`F.grid_sample`), then summed with the weights over levels and points:
    (B, len_q, nh * hd), in the dtype the three share.
    """
    B, _, nh, hd = value.shape
    len_q = locations.shape[1]
    grids = 2 * locations - 1
    sampled = []
    for lvl, v in enumerate(value.split([h * w for h, w in shapes], dim=1)):
        h, w = shapes[lvl]
        v = v.flatten(2).transpose(1, 2).reshape(B * nh, hd, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (B * nh, len_q, np, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
    aw = weights.transpose(1, 2).reshape(B * nh, 1, len_q, -1)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1)  # (B * nh, hd, len_q)
    return out.view(B, nh * hd, len_q).transpose(1, 2)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (JAX :127-162): value_proj, sampling_offsets and attention_weights of the
    query, the offsets scaled by each reference box's size (`refer_bbox[..., 2:] * 0.5 / np`), output_proj."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.np, self.hd = n_heads, n_levels, n_points, d_model // n_heads
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, refer_bbox: torch.Tensor, value: torch.Tensor,
                shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, len_q, C); refer_bbox (B, len_q, 1, 4) cxcywh in [0, 1], `box_dtype`; value (B, len_v, C)."""
        B, len_q = query.shape[:2]
        ct = box_dtype(self.value_proj.weight)
        v = self.value_proj(value).view(B, -1, self.nh, self.hd).to(ct)
        offsets = self.sampling_offsets(query).view(B, len_q, self.nh, self.nl, self.np, 2)
        aw = self.attention_weights(query).view(B, len_q, self.nh, self.nl * self.np)
        aw = aw.softmax(-1, dtype=ct).view(B, len_q, self.nh, self.nl, self.np)
        add = offsets.to(ct) / self.np * refer_bbox[:, :, None, :, None, 2:] * 0.5
        locations = refer_bbox[:, :, None, :, None, :2] + add
        out = multi_scale_deformable_attn(v, shapes, locations, aw)  # f32 (f64 in an f64 model)
        return self.output_proj(out.to(self.output_proj.weight.dtype))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and FFN, each with a residual and a LayerNorm (JAX :165-192).
    `attn_mask` (Lq, Lq) bool arrives True = blocked, as in JAX, and reaches the attention inverted; the serving
    branch passes none."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos, attn_mask: Optional[torch.Tensor] = None):
        q = embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, None if attn_mask is None else ~attn_mask))
        embed = self.norm2(embed + self.cross_attn(embed + query_pos, refer_bbox[:, :, None, :], feats, shapes))
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def select_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest of each row of `scores` (B, A), largest first, ties to the lower index:
    `jax.lax.top_k`'s order. A stable descending sort gives it on the CPU and on CUDA alike; torch.topk
    promises no order among equal values, and the anchors outside the valid band all score alike."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]


def make_anchors(shapes: Sequence[Tuple[int, int]], device, grid_size: float = 0.05,
                 eps: float = 1e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's anchors in logit space (A, 4) f32 and their validity (A, 1) (JAX :232-242): each cell's
    centre over the map and a width and height of grid_size * 2^level; a cell with a coordinate outside
    (eps, 1 - eps) is invalid and its anchor +inf."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
        xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32, device=device)
        wh = torch.full((h, w, 2), grid_size * 2.0 ** i, dtype=torch.float32, device=device)
        anchors.append(torch.cat([xy, wh], -1).reshape(h * w, 4))
    anchors = torch.cat(anchors)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    return torch.where(valid, torch.log(anchors / (1 - anchors)), torch.inf), valid


class RTDETRDecoder(nn.Module):
    """The RT-DETR head (JAX :195-313).

    Each level's map through `input_proj.<i>` (1x1 conv, BN eps 1e-3 and torch momentum 0.03, flax's 0.97) into
    (B, h * w, hd) tokens; the valid anchors' tokens through `enc_output` (Linear, LayerNorm) and
    `enc_score_head`; the k = min(nq, A) best anchors by their best class score (`select_topk`) give the queries
    and, through `enc_bbox_head` plus the anchor, the first reference boxes; then ndl decoder layers, each
    refining the boxes by `dec_bbox_head.<i>` in logit space.

    Serving (eval mode): (B, k, 4 + nc), the last layer's normalised cxcywh boxes and sigmoid scores; only the last
    layer's score head runs.

    Training (train mode, JAX :246-311): the queries are the selected features detached and the first reference
    boxes `sigmoid(refer_raw.detach())`, while the encoder's boxes and scores keep their gradient. With a
    denoising batch `dn` = {'cls' (B, M), 'bboxes' (B, M, 4) normalised cxcywh, 'mask' (B, M), and 'generator'
    or 'draws' (`losses/detr.py::get_cdn_group`)}, the 2GM noised queries of `denoising_class_embed` (nc, hd) and
    their boxes come first, under the group attention mask. Every layer runs its own score head and appends its
    refined boxes; the next layer's reference is the refined box, detached. Returns {'dec_bboxes' (ndl, B,
    num_dn + k, 4), 'dec_scores' (ndl, B, num_dn + k, nc), 'enc_bboxes' (B, k, 4), 'enc_scores' (B, k, nc),
    'dn_split' num_dn, 'dn_group' G}.
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (512, 1024, 2048), hd: int = 256, nq: int = 300,
                 ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.nq, self.nl = nc, nq, len(ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd, eps=BN_EPS, momentum=BN_MOMENTUM))
            for c in ch)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=LN_EPS))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.denoising_class_embed = nn.Parameter(torch.randn(nc, hd))
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.decoder_layers = nn.ModuleList(DeformableTransformerDecoderLayer(hd, nh, d_ffn, self.nl, ndp)
                                            for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc) for _ in range(ndl))

    def encode(self, xs: Sequence[torch.Tensor]):
        """The tokens (B, A, hd), the level shapes, the anchors (A, 4), the encoder head's features (B, A, hd) and
        its scores (B, A, nc), before the top-k selection."""
        feats, shapes = [], []
        for proj, x in zip(self.input_proj, xs):
            f = proj(x)
            shapes.append(tuple(f.shape[2:]))
            feats.append(f.flatten(2).transpose(1, 2))
        feats = torch.cat(feats, 1)
        anchors, valid = make_anchors(shapes, feats.device)
        features = self.enc_output(valid * feats)
        return feats, shapes, anchors, features, self.enc_score_head(features)

    def forward(self, xs: Sequence[torch.Tensor], dn: Optional[Dict] = None):
        feats, shapes, anchors, features, scores = self.encode(xs)
        idx = select_topk(scores.amax(-1), min(self.nq, scores.shape[1]))  # (B, k)
        embed = features.gather(1, idx[..., None].expand(-1, -1, features.shape[-1]))
        ct = box_dtype(self.enc_score_head.weight)
        refer_raw = self.enc_bbox_head(embed).to(ct) + anchors[idx].to(ct)
        if not self.training:
            refer_bbox = refer_raw.sigmoid()
            for layer, bbox_head in zip(self.decoder_layers, self.dec_bbox_head):
                embed = layer(embed, refer_bbox, feats, shapes, self.query_pos_head(refer_bbox))
                refer_bbox = (bbox_head(embed).to(ct) + inverse_sigmoid(refer_bbox)).sigmoid()
            return torch.cat([refer_bbox, self.dec_score_head[-1](embed).to(ct).sigmoid()], -1)
        enc_bboxes = refer_raw.sigmoid()
        enc_scores = scores.gather(1, idx[..., None].expand(-1, -1, scores.shape[-1]))
        embed, refer_bbox = embed.detach(), refer_raw.detach().sigmoid()
        attn_mask, num_dn, dn_group = None, 0, 0
        if dn is not None:
            from ..losses.detr import get_cdn_group

            dn_embed, dn_bbox_logit, attn_mask, dn_group = get_cdn_group(
                dn["cls"], dn["bboxes"], dn["mask"], self.nc, self.denoising_class_embed, embed.shape[1],
                generator=dn.get("generator"), draws=dn.get("draws"))
            num_dn = dn_embed.shape[1]
            embed = torch.cat([dn_embed.to(embed.dtype), embed], 1)
            refer_bbox = torch.cat([dn_bbox_logit.sigmoid().to(refer_bbox.dtype), refer_bbox], 1)
        dec_bboxes, dec_scores = [], []
        for layer, bbox_head, score_head in zip(self.decoder_layers, self.dec_bbox_head, self.dec_score_head):
            embed = layer(embed, refer_bbox, feats, shapes, self.query_pos_head(refer_bbox), attn_mask)
            refined = (bbox_head(embed).to(ct) + inverse_sigmoid(refer_bbox)).sigmoid()
            dec_scores.append(score_head(embed))
            dec_bboxes.append(refined)
            refer_bbox = refined.detach()
        return {"dec_bboxes": torch.stack(dec_bboxes), "dec_scores": torch.stack(dec_scores),
                "enc_bboxes": enc_bboxes, "enc_scores": enc_scores, "dn_split": num_dn, "dn_group": dn_group}
