"""Post-training int8 quantization of the serving copy (counterpart of `lpc_yolo_tpu/nn/quant.py`).

The scheme is the JAX package's:

  * per-output-channel symmetric int8 weights from the BN-folded kernel in the serving dtype:
    `sw = max(absmax over (kh, kw, Cin), 1e-12) / 127`, `W8 = round(Wf / sw)` (a division);
  * per-tensor symmetric int8 activations: `sx = max(absmax, 1e-12) / 127` in double,
    `x8 = clip(round(x * f32(1 / sx)), -127, 127)`, round half to even; the absmax of every site's input
    is recorded over calibration batches (one serving pass a batch, reduced with max across batches);
  * s32 accumulation, then `acc * (sx * sw[c]) + b` and the activation (in f32 on the card, then the
    serving dtype; the JAX package rounds to the serving dtype before the bias).

A site is a folded `ConvBN` or `RepConv` that passes the JAX rule (`_site_eligible`,
`lpc_yolo_tpu/nn/quant.py:90-97`: groups 1, undilated, min(Cin, Cout) >= 64) on its logical channel counts
(`nn/fuse.py::int8_sites`). The port serves the plain graph, none of the TPU deploy rewrites (width packing,
the upsample-commute split, C2f's kernel algebra, the s2d fold), so where the JAX int8 graph quantizes a
rewritten conv the two quantize other tensors (ROADMAP Queue 3). A RepConv serves folded, so it is one site
(the sum of its branches' kernels, one per-channel weight scale) where the JAX package quantizes its 3x3 and
1x1 branches as two sites on the same input (the same activation scale). A concat read by a 1x1 conv is one
site with one scale over all its parts, as `q8_concat_conv` / `q8_pool_concat_conv`: a C2f / C2fCIB tail (cv2
over cv1's output and each bottleneck's), a C2fAttn tail (the same and the attention's output), an HGBlock's
`sc` (the input and each conv's output) and the SPPF tail (cv2 over x and its three pools). Each part is
quantized into its channel slice of one s8 buffer, so the concat is never built in bf16. The SPPF pools run in
the serving dtype and their outputs are quantized with x's scale: quantization is monotone and every pooling
window holds a real element, so that gives the s8 values of pooling in s8.

Heads: the JAX `suspend()` (`lpc_yolo_tpu/nn/compiler.py:825-835`) keeps the Detect, Segment, Pose, OBB,
RTDETRDecoder and WorldDetect heads unquantized; a v10Detect head quantizes the ConvBNs of its one-to-one
towers (the one-to-many towers do not serve), and its final box and class projections are plain `nn.Conv2d`
in the serving dtype. Classify is no such head: its 1x1 conv to 1280 is a site, as in JAX. A World graph is
calibrated on the text it serves with (`calibrate(..., text=)`); the JAX package calibrates on zero text
(ROADMAP Queue 3).

Sites are keyed by their qualified module name in the serving copy (a deep copy, so the names are the
model's own), whatever order a forward visits them in. The kernels: `ops/quantize_s8.py` (one launch a
part) and `ops/conv_s8.py` (one launch a site).
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_s8 import conv_s8
from ..ops.quantize_s8 import quantize_s8
from .fuse import Int8Site, int8_sites


def act_scale(absmax: float) -> Tuple[float, float]:
    """(sx, inv) of a calibrated absmax: sx in double as the JAX package takes it, inv the f32 of 1 / sx."""
    sx = max(float(absmax), 1e-12) / 127.0
    return sx, float(np.float32(1.0 / sx))


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A folded OIHW kernel (in the serving dtype) -> (W8 (Co, kh, kw, Cin) s8, sw (Co,) f32)."""
    wf = w.float()
    sw = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    w8 = torch.round(wf / sw[:, None, None, None]).to(torch.int8)
    return w8.permute(0, 2, 3, 1).contiguous(), sw


class Q8Conv(NamedTuple):
    """A quantized site: its s8 weights and scales, the activation scale, the f32 bias and the stride."""
    w8: torch.Tensor
    sw: torch.Tensor
    sx: float
    inv: float
    b: torch.Tensor
    stride: int

    def run(self, parts: Sequence[torch.Tensor], act) -> torch.Tensor:
        """act(conv(concat(parts)) + b) of NCHW parts (one or more, one scale over all), quantized part by part
        into one NHWC s8 buffer; the output is NCHW (channels_last) in the parts' dtype."""
        x0 = parts[0]
        B, _, H, W = x0.shape
        x8 = torch.empty((B, H, W, sum(p.shape[1] for p in parts)), dtype=torch.int8, device=x0.device)
        off = 0
        for p in parts:
            c = p.shape[1]
            quantize_s8(p.permute(0, 2, 3, 1), self.inv, out=x8[..., off:off + c])
            off += c
        return conv_s8(x8, self.w8, self.sw, self.sx, self.b, act, self.stride, x0.dtype).permute(0, 3, 1, 2)


def quantize_conv(site: Int8Site, absmax: float) -> Q8Conv:
    """The int8 form of a folded site (a ConvBN or a RepConv) from its stored folded (W, b) and its input's
    calibrated absmax."""
    w, b = site.module.folded
    if site.module.kernel_path:  # HWIO for the conv3x3 kernel
        w = w.permute(3, 2, 0, 1)
    w8, sw = quantize_weight(w)
    sx, inv = act_scale(absmax)
    return Q8Conv(w8, sw, sx, inv, b.float().contiguous(), site.conv.stride[0])


@torch.inference_mode()
def calibrate(serving: nn.Module, batches: Iterable[torch.Tensor],
              text: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Record the absmax of every site's input over `batches` (each as the serving copy takes it: the raw
    0..255 letterboxed frames, NCHW, in its dtype), one `serving.predict` a batch, reduced with max across
    batches (JAX `calibrate_serving`, `lpc_yolo_tpu/nn/quant.py:252-293`). `serving` is an unquantized
    folded serving copy (`engine/predictor.py::serving_model(..., int8=False)`). A World graph reads `text`,
    the (1, M, 512) table it serves with, broadcast to each batch (None: zeros of (B, nc, 512), the JAX
    record pass's text)."""
    sites = int8_sites(serving)
    if not sites:
        raise ValueError("no quantizable conv sites found in the serving graph")
    seen: Dict[str, torch.Tensor] = {}

    def recorder(name):
        def hook(_module, args):
            a = args[0].abs().amax().float()
            seen[name] = a if name not in seen else torch.maximum(seen[name], a)
        return hook

    handles = [s.module.register_forward_pre_hook(recorder(s.name)) for s in sites]
    try:
        for x in batches:
            serving.predict(x, text=None if text is None else text.expand(len(x), -1, -1))
    finally:
        for h in handles:
            h.remove()
    missing = [s.name for s in sites if s.name not in seen]
    if missing:
        raise ValueError(f"calibration saw no input at the int8 sites {missing}")
    return {s.name: float(seen[s.name]) for s in sites}


def quantize_serving(serving: nn.Module, scales: Dict[str, float]) -> nn.Module:
    """Turn each site of a folded serving copy into its int8 form (in place), from the calibrated absmax of
    its input; a site with no scale, or a scale of no site, raises."""
    sites = int8_sites(serving)
    names = {s.name for s in sites}
    missing = [n for n in names if n not in scales]
    stale = [n for n in scales if n not in names]
    if missing or stale:
        raise ValueError(f"int8 serving needs calibrated scales for its {len(sites)} sites: missing {sorted(missing)}, "
                         f"no such site {sorted(stale)}; run YOLO.quantize_int8 (nn/quant.py::calibrate) first")
    for s in sites:
        if s.module.folded is None:
            raise ValueError(f"int8 site {s.name} is not folded: quantize a serving copy (fuse_conv_bn)")
        s.module.q8 = quantize_conv(s, scales[s.name])
    return serving


# -- the JAX functions' faces (NHWC x, HWIO W), for holding the port to `lpc_yolo_tpu/nn/quant.py` --------------

def _q8_weight(W: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_weight(W.permute(3, 2, 0, 1))


def _same(W: torch.Tensor, padding) -> None:
    p = W.shape[0] // 2
    if [tuple(q) for q in padding] != [(p, p), (p, p)]:
        raise NotImplementedError(f"the port's int8 convs are same-padded: padding {padding} for a {W.shape[0]}x"
                                  f"{W.shape[1]} kernel")


def q8_conv(x: torch.Tensor, W: torch.Tensor, strides=(1, 1), padding=((0, 0), (0, 0)),
            scale: Optional[float] = None) -> torch.Tensor:
    """JAX `q8_conv`: the un-biased, un-activated conv of NHWC x and HWIO W in x's dtype, through the s8 path
    with the calibrated input absmax `scale` (None: not a site, the plain conv)."""
    _same(W, padding)
    if scale is None:
        p = W.shape[0] // 2
        y = F.conv2d(x.permute(0, 3, 1, 2), W.permute(3, 2, 0, 1).to(x.dtype), stride=strides, padding=p)
        return y.permute(0, 2, 3, 1)
    return q8_concat_conv([x], W, scale, strides, padding)


def q8_concat_conv(parts: Sequence[torch.Tensor], W: torch.Tensor, scale: float, strides=(1, 1),
                   padding=((0, 0), (0, 0))) -> torch.Tensor:
    """JAX `q8_concat_conv`: conv(concat(parts, -1)) with one scale over all parts, the concat in s8."""
    _same(W, padding)
    w8, sw = _q8_weight(W)
    sx, inv = act_scale(scale)
    site = Q8Conv(w8, sw, sx, inv, torch.zeros(W.shape[3], device=W.device), strides[0])
    return site.run([p.permute(0, 3, 1, 2) for p in parts], False).permute(0, 2, 3, 1)


def q8_pool_concat_conv(x: torch.Tensor, W: torch.Tensor, k: int, scale: float, n_pools: int = 3) -> torch.Tensor:
    """JAX `q8_pool_concat_conv`: the SPPF tail conv(concat([x, pool(x), ..., pool^n(x)])) with x's scale;
    the pools run in x's dtype and each is quantized with that scale (the same s8 values as pooling in s8)."""
    ys = [x.permute(0, 3, 1, 2)]
    for _ in range(n_pools):
        ys.append(F.max_pool2d(ys[-1], k, 1, k // 2))
    return q8_concat_conv([y.permute(0, 2, 3, 1) for y in ys], W, scale)
