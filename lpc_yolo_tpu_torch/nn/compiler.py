"""YAML -> LayerSpecs -> DetectionModel (counterpart of `lpc_yolo_tpu/nn/compiler.py`).

Same schema and channel inference as the JAX compiler (make_divisible :87,
LayerSpec :94, yaml_model_load :110, parse_model :119-284), implemented for
the modules that the LPC-YOLO YAML, the six YOLOv10 scales (n/s/m/b/l/x) and
the five YOLOv8 scales (n/s/m/l/x), detect, segment, pose, OBB and classify, the ResNet
classifiers, the other CNN detection YAMLs (v8 P2 / P6 / ghost / seg-P6 / pose-P6,
v5 and v5-P6, v3, v3-SPP, v3-tiny, v6), YOLOv9 (v9c, v9e) and RT-DETR (rtdetr-l, -x, -resnet50, -resnet101,
yolov8-rtdetr: HGStem, HGBlock, LightConv, RepC3, AIFI and the RTDETRDecoder head, `nn/transformer.py`) and
YOLO-World (yolov8-world, -worldv2: C2fAttn, ImagePoolingAttn and the WorldDetect head)
reach, and the research zoo's 21 attention modules, 15 neck blocks and 23 backbone-family modules (`nn/research.py`;
JAX :243-276 and `build_research_module`; ASFF2 / ASFF3 take the list of their levels' maps, JAX :975; LeYOLO's
expansion width scales and StarBlock folds its repeats, :256-267); any other module raises NotImplementedError. A
CBLinear layer's output is a tuple of maps, which the CBFuse layers that list it read by index (:230-238).
A layer repeated n > 1 times that takes no repeat count of its own (v3's Bottlenecks, v6's
Convs) is an nn.Sequential of n copies, `model.<i>.<rep>`, the JAX graph's `model_<i>_<rep>`
(:988-995). The YAML's `activation:` key sets the conv.py family's default activation
(:1081-1084), which each ConvBN resolves when it is built (`modules.DEFAULT_ACT`). The
model routes `from` indices and keeps the save list like `DetectionModel._run` (:718-1019),
without the TPU width-pack, upsample-commute, s2d-fold plans or int8. A layer whose output no later layer reads
(layer 27 of the LPC YAML) keeps its module and weights. In eval mode it is
not computed, as XLA's dead-code pass drops it in the JAX graph; in train mode
it runs, because there its BatchNorm statistics are an output of the JAX
train step and move with every batch. An ImagePoolingAttn layer is never dead: no layer reads its
output, which is its input passed through, but it replaces the running text that later C2fAttn layers
read (JAX :812-822).
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import yaml

from ..ops.boxes import xywh2xyxy
from ..ops.nms import nms_rotated, non_max_suppression
from ..ops.repack import repack_width_kernel
from ..utils import resolve_device
from . import modules as M
from . import research as R
from .heads import (OBB, Classify, Detect, Pose, Segment, V10Detect, WorldDetect, decode_feats, decode_feats_obb,
                    decode_feats_topk_split, decode_kpts)
from .transformer import AIFI, RTDETRDecoder

# Modules whose YAML arg[0] is the (width-scaled) output-channel count, and the
# subset that also takes the (depth-scaled) repeat count.
_BASE = {"Conv", "DWConv", "GhostConv", "Bottleneck", "SPPF", "SPP", "C2f", "C2", "C3", "C3Ghost", "PSA", "LPC",
         "SCDown", "C2fCIB", "RepNCSPELAN4", "ADown", "SPPELAN", "RepConv", "RepC3", "LightConv", "C2fAttn"}
_REPEAT = {"C2f", "C2", "C3", "C3Ghost", "C2fCIB", "RepC3", "C2fAttn"}
# the YAML `activation:` values the port takes (the JAX package's act_map, :1083, less GELU, which no conv3x3
# epilogue has); the JAX `apply_act` applies SiLU for Mish (ROADMAP Queue 3), the port Mish as the reference does
_ACTIVATIONS = {"nn.ReLU()": "relu", "nn.SiLU()": "silu", "nn.Mish()": "mish"}
# the ported heads, each one's task (JAX names)
HEAD_TASKS = {"v10Detect": "v10", "Detect": "v8", "Segment": "segment", "Pose": "pose", "OBB": "obb",
              "Classify": "classify", "RTDETRDecoder": "rtdetr", "WorldDetect": "world"}
# the layers that read the text embeddings (B, M, 512) of a YOLO-World graph
TEXT_MODULES = {"C2fAttn", "ImagePoolingAttn", "WorldDetect"}
TEXT_DIM = 512  # the width of the zero text a World graph takes when it is given none (JAX :738-743)
# RTDETRDecoder's YAML args after nc, in the reference ctor's order (JAX :887-898)
_DETR_ARGS = ("hd", "nq", "ndp", "nh", "ndl", "d_ffn")


def make_divisible(x: float, divisor: int = 8) -> int:
    return math.ceil(x / divisor) * divisor


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One compiled graph node: routing + module + resolved static args."""

    i: int
    f: Tuple[int, ...]  # 'from' indices (-1 = previous)
    n: int  # resolved repeat count
    module: str
    args: Tuple[Any, ...]  # resolved ctor args (after channel inference)
    c2: int  # output channels


def guess_model_scale(path: Union[str, Path]) -> str:
    m = re.search(r"yolov\d+([nsmblx])", Path(path).stem)
    return m.group(1) if m else ""


def yaml_model_load(path: Union[str, Path]) -> Dict:
    """Load a model YAML, recording the inferred scale."""
    path = Path(path)
    d = yaml.safe_load(path.read_text())
    d["scale"] = d.get("scale") or guess_model_scale(path)
    d["yaml_file"] = str(path)
    return d


def parse_model(d: Dict, ch: int = 3) -> Tuple[Tuple[LayerSpec, ...], Tuple[int, ...]]:
    """Compile the YAML dict into LayerSpecs with resolved channels, and the save list."""
    nc = d["nc"]
    depth = d.get("depth_multiple", 1.0)
    width = d.get("width_multiple", 1.0)
    max_channels = float("inf")
    scales = d.get("scales")
    if scales:
        scale = d.get("scale") or tuple(scales.keys())[0]
        if scale not in scales:
            scale = tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    chs: List[int] = [ch]
    specs: List[LayerSpec] = []
    save: List[int] = []
    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        args = [nc if a == "nc" else (tuple(d["kpt_shape"]) if a == "kpt_shape" else a) for a in list(args)]
        n_res = max(round(n * depth), 1) if n > 1 else n
        f_list = [f] if isinstance(f, int) else list(f)
        f_list = [x if x == -1 or x >= 0 else x + i for x in f_list]

        if m in _BASE:
            c1, c2 = chs[f_list[0]], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            if m == "C2fAttn":  # the embedding width and the head count scale too (JAX :156-160, tasks.py:902-906)
                args[1] = make_divisible(min(args[1], max_channels // 2) * width, 8)
                args[2] = int(max(round(min(args[2], max_channels // 2 // 32)) * width, 1) if args[2] > 1 else args[2])
            out_args = [c1, c2, *args[1:]]
            if m in _REPEAT:
                out_args.insert(2, n_res)
                n_res = 1
        elif m == "Concat":
            c2 = sum(chs[x] for x in f_list)
            out_args = list(args)
        elif m == "Classify":  # c2 = nc, unscaled (JAX compiler.py:212-214)
            c1, c2 = chs[f_list[0]], args[0]
            out_args = [c1, c2, *args[1:]]
        elif m == "ResNetLayer":  # args unscaled; c2 the planes, x4 past the stem (JAX compiler.py:180-184)
            c2 = args[1] if args[3] else args[1] * 4
            out_args = list(args)
        elif m in HEAD_TASKS:
            if m == "Segment":  # npr scales with the width (JAX compiler.py:187-188)
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            out_args = [*args, tuple(chs[x] for x in f_list)]
            c2 = chs[f_list[-1]]
        elif m == "ImagePoolingAttn":  # [ec (unscaled), the levels' widths]; its input passes through (JAX :239-242)
            out_args = [*args, tuple(chs[x] for x in f_list)]
            c2 = chs[f_list[-1]]
        elif m in ("CBAM", "AIFI"):  # [c1, *args], the width kept (JAX :168-172)
            c1 = chs[f_list[0]]
            out_args = [c1, *args]
            c2 = c1
        elif m in ("HGStem", "HGBlock"):  # [c1, cm, c2, *rest], unscaled; HGBlock's n at 4 (JAX :173-179)
            c1, cm, c2 = chs[f_list[0]], args[0], args[1]
            out_args = [c1, cm, c2, *args[2:]]
            if m == "HGBlock":
                out_args.insert(4, n_res)
                n_res = 1
        elif m == "space_to_depth":
            c2 = 4 * chs[f_list[0]]
            out_args = list(args)
        elif m in ("nn.Upsample", "nn.MaxPool2d", "nn.ZeroPad2d", "Silence"):
            c2 = chs[f_list[0]]
            out_args = list(args)
        elif m == "CBLinear":  # c2 the tuple of widths, unscaled; only CBFuse reads it (JAX :230-235)
            c1, c2 = chs[f_list[0]], tuple(args[0])
            out_args = [c1, c2, *args[1:]]
        elif m == "CBFuse":  # (JAX :236-238)
            c2 = chs[f_list[-1]]
            out_args = [tuple(args[0])]
        elif m in R.MULTI_INPUT:  # ASFF: [the levels' widths, c2 width-scaled, level]; level's width out (JAX :243-250)
            c1l = [chs[x] for x in f_list]
            level = args[1] if len(args) > 1 else 0
            out_args = [tuple(c1l), make_divisible(min(args[0], max_channels) * width, 8), level]
            c2 = c1l[level]
        elif m == "nn.ConvTranspose2d" or m in R.WIDTH_SCALED:  # width-scaled as a base module (JAX :221-226, :251-260)
            c1, c2 = chs[f_list[0]], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            out_args = [c1, c2, *args[1:]]
            if m in R.WIDTH_SCALED_E and len(out_args) > 3 and isinstance(out_args[3], int):  # LeYOLO's e (:256-257)
                out_args[3] = make_divisible(min(out_args[3], max_channels) * width, 8)
            if m in R.WIDTH_REPEAT:  # C2f_MSBlock, VoVGSCSP, ConvNeXt_Block: n folded into the block
                out_args.insert(2, n_res)
                n_res = 1
        elif m in R.C1_PREPEND:  # the research zoo's attention family, neck blocks, StarBlock, BasicStage (:261-271)
            c1 = c2 = chs[f_list[0]]
            out_args = [c1, *args]
            if m == "StarBlock":  # [c1, mlp_ratio, the repeats]: n folded into the block (:265-267)
                out_args = [c1, args[0] if args else 3, n_res]
                n_res = 1
        elif m in R.C1_ONLY:
            c1 = c2 = chs[f_list[0]]
            out_args = [c1]
        elif m in R.PASSTHROUGH:
            c2 = chs[f_list[0]]
            out_args = list(args)
        else:
            raise NotImplementedError(f"module '{m}' is not ported to torch yet (layer {i})")

        specs.append(LayerSpec(i, tuple(f_list), n_res, m, tuple(tuple(a) if isinstance(a, list) else a
                                                                   for a in out_args), c2))
        save.extend(x % i for x in f_list if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)
    return tuple(specs), tuple(sorted(set(save)))


def _build_module(spec: LayerSpec, strides) -> nn.Module:
    m, a = spec.module, spec.args
    if spec.n > 1:  # n copies in sequence, each after the first taking the c2 channels (JAX :988-995); a
        one = dataclasses.replace(spec, n=1)  # passthrough module's args name no channels
        rest = one if m in R.PASSTHROUGH else dataclasses.replace(one, args=(spec.c2, *a[1:]))
        return nn.Sequential(*(_build_module(one if r == 0 else rest, strides) for r in range(spec.n)))
    if m in R.PORTED:
        return R.build_research_module(m, a)
    if m == "Conv":
        k = a[2] if len(a) > 2 else 1
        s = a[3] if len(a) > 3 else 1
        p = a[4] if len(a) > 4 and a[4] not in (None, "None") else None
        g = a[5] if len(a) > 5 else 1
        d = a[6] if len(a) > 6 else 1
        act = "silu" if (len(a) <= 7 or a[7] is True) else (a[7] or False)
        return M.ConvBN(a[0], a[1], k, s, p=p, g=g, d=d, act=act)
    if m == "DWConv":
        act = "silu" if (len(a) <= 5 or a[5] is True) else (a[5] or False)
        return M.DWConv(a[0], a[1], a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 else 1,
                        a[4] if len(a) > 4 else 1, act=act)
    if m == "GhostConv":
        return M.GhostConv(a[0], a[1], a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 else 1)
    if m == "Bottleneck":
        return M.Bottleneck(*a)
    if m in ("C2", "C3", "C3Ghost"):
        return getattr(M, m)(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else True)
    if m == "SPP":
        return M.SPP(a[0], a[1], a[2] if len(a) > 2 else (5, 9, 13))
    if m == "nn.MaxPool2d":
        return M.MaxPool2d(a[0], a[1] if len(a) > 1 else a[0], a[2] if len(a) > 2 else 0)
    if m == "nn.ZeroPad2d":
        return M.ZeroPad2d(a[0])
    if m == "nn.ConvTranspose2d":
        return M.ConvTranspose(a[0], a[1], a[2] if len(a) > 2 else 2, a[3] if len(a) > 3 else 2,
                               a[4] if len(a) > 4 else 0)
    if m == "SPPF":
        return M.SPPF(a[0], a[1], a[2] if len(a) > 2 else 5)
    if m == "C2f":
        return M.C2f(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False)
    if m == "PSA":
        return M.PSA(a[0], a[1])
    if m == "SCDown":
        return M.SCDown(a[0], a[1], a[2], a[3])
    if m == "C2fCIB":
        return M.C2fCIB(a[0], a[1], n=a[2], shortcut=a[3] if len(a) > 3 else False,
                        lk=a[4] if len(a) > 4 else False)
    if m == "LPC":
        return M.LPC(a[0], a[1], a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 else 1)
    if m == "CBAM":
        return M.CBAM(a[0], a[1] if len(a) > 1 else 7)
    if m == "space_to_depth":
        return M.SpaceToDepth()
    if m == "nn.Upsample":
        return M.Upsample(int(a[1]))
    if m == "RepNCSPELAN4":
        return M.RepNCSPELAN4(a[0], a[1], a[2], a[3], a[4] if len(a) > 4 else 1)
    if m == "ADown":
        return M.ADown(a[0], a[1])
    if m == "SPPELAN":
        return M.SPPELAN(a[0], a[1], a[2], a[3] if len(a) > 3 else 5)
    if m == "RepConv":  # the YAML-level RepConv keeps its identity branch (JAX :647-648)
        return M.RepConv(a[0], a[1], a[2] if len(a) > 2 else 3, a[3] if len(a) > 3 else 1)
    if m == "Silence":
        return M.Silence()
    if m == "RepC3":
        return M.RepC3(a[0], a[1], n=a[2], e=a[3] if len(a) > 3 else 1.0)
    if m == "LightConv":
        return M.LightConv(a[0], a[1], a[2] if len(a) > 2 else 1)
    if m == "HGStem":
        return M.HGStem(a[0], a[1], a[2])
    if m == "HGBlock":
        return M.HGBlock(a[0], a[1], a[2], k=a[3] if len(a) > 3 else 3, n=a[4] if len(a) > 4 else 6,
                         lightconv=bool(a[5]) if len(a) > 5 else False, shortcut=bool(a[6]) if len(a) > 6 else False)
    if m == "AIFI":
        return AIFI(a[0], a[1] if len(a) > 1 else 2048, a[2] if len(a) > 2 else 8)
    if m == "CBLinear":
        return M.CBLinear(a[0], a[1], a[2] if len(a) > 2 else 1, a[3] if len(a) > 3 else 1)
    if m == "CBFuse":
        return M.CBFuse(a[0])
    if m == "ResNetLayer":  # the YAML's c1 (args[0]) is the input's width in every ResNet YAML (JAX :662-666)
        return M.ResNetLayer(a[0], a[1], s=a[2] if len(a) > 2 else 1, is_first=bool(a[3]) if len(a) > 3 else False,
                             n=a[4] if len(a) > 4 else 1)
    if m == "Classify":
        return Classify(a[0], nc=a[1])
    if m == "Concat":
        return M.Concat()
    if m == "v10Detect":
        return V10Detect(nc=a[0], ch=a[-1], strides=strides)
    if m == "Detect":
        return Detect(nc=a[0], ch=a[-1], strides=strides)
    if m == "Segment":
        return Segment(nc=a[0], nm=a[1], npr=a[2], ch=a[-1], strides=strides)
    if m == "Pose":  # kpt_shape defaults to COCO's (17, 3), as in the JAX graph (:901)
        return Pose(nc=a[0], kpt_shape=a[1] if len(a) > 2 else (17, 3), ch=a[-1], strides=strides)
    if m == "OBB":  # ne defaults to 1, as in the JAX graph (:918)
        return OBB(nc=a[0], ne=a[1] if len(a) > 2 else 1, ch=a[-1], strides=strides)
    if m == "RTDETRDecoder":
        return RTDETRDecoder(nc=a[0], ch=a[-1], **dict(zip(_DETR_ARGS, a[1:-1])))
    if m == "C2fAttn":  # [c1, c2, n, ec, nh, gc] (JAX :617-621)
        return M.C2fAttn(a[0], a[1], n=a[2], ec=a[3], nh=a[4] if len(a) > 4 else 1, gc=a[5] if len(a) > 5 else 512)
    if m == "ImagePoolingAttn":
        return M.ImagePoolingAttn(ec=a[0], ch=a[-1])
    if m == "WorldDetect":  # [nc, embed, with_bn, ch] (JAX :836-846)
        return WorldDetect(nc=a[0], embed=a[1] if len(a) > 2 else 512, with_bn=bool(a[2]) if len(a) > 3 else False,
                           ch=a[-1], strides=strides)
    raise NotImplementedError(m)


class DetectionModel(nn.Module):
    """Compiled YOLO graph with 'from'-index routing.

    `forward(x)` returns the head's raw maps: per-level (box, cls) pairs, in
    a dict by branch for v10Detect; a Segment head returns what the JAX graph
    returns (:931-947): {"feats", "mc", "proto"} in train mode, and in eval
    mode also "pred" (the v8 decode); a Pose head (:900-915) {"feats",
    "kpt_raw"} in train mode and {"feats", "pred", "kpt"} (the keypoints
    decoded) in eval mode; an OBB head (:917-930) {"feats", "angle"} in train
    mode and also "pred" (`decode_feats_obb`) in eval mode. `predict(x)`
    decodes them to (B, max_det, 6): v10Detect's one-to-one branch through the
    NMS-free top-k, Detect's, Segment's and Pose's maps through `decode_feats`
    and `non_max_suppression`; for Segment with each row's mask coefficients
    and the prototypes, for Pose with each row's keypoints; an OBB model's to
    (B, max_det, 7) rotated rows by `nms_rotated` (see `predict`). A Classify head (:967-973) returns
    its logits (B, nc) in train mode and {"probs" (softmax in f32), "logits"} in eval mode; a classify
    graph has no strides. An RTDETRDecoder head (:887-898) returns {"pred"} in eval mode, (B, nq, 4 + nc)
    normalised cxcywh boxes and sigmoid scores, and in train mode the DETR loss's dict of every decoder
    layer's outputs, with the denoising queries of `dn` (`nn/transformer.py::RTDETRDecoder`) first. A World graph
    reads `text` (B, M, 512), zeros of (B, nc, 512) when none is given (JAX :738-745): every C2fAttn the running
    text, which an ImagePoolingAttn replaces by its output, and WorldDetect the original, whose (box, cls) pairs
    have M class channels.
    x is (B, 3, H, W)
    RGB in [0, 1], or another `input_layout` of the same image (see
    `to_nchw`). `grid` (`ops/anchors.py::Grid`) gives the Segment, Pose and OBB decodes their anchors for
    this input's shape, which they make otherwise (an export graph holds them as buffers).
    """

    def __init__(self, specs: Tuple[LayerSpec, ...], save: Tuple[int, ...], nc: int,
                 strides: Tuple[float, ...] = (8.0, 16.0, 32.0), reg_max: int = 16, default_act: str = "silu"):
        super().__init__()
        self.specs, self.save, self.nc = specs, save, nc
        self.strides, self.reg_max, self.default_act = tuple(strides), reg_max, default_act
        token = M.DEFAULT_ACT.set(default_act)
        try:
            self.model = nn.ModuleList(_build_module(s, self.strides) for s in specs)
        finally:
            M.DEFAULT_ACT.reset(token)
        self.task = HEAD_TASKS.get(specs[-1].module) if specs else None  # None: a headless graph
        read = {j for s in specs for j in s.f if j != -1}
        read |= {s.i - 1 for s in specs if -1 in s.f}
        # layers nothing reads (besides the head): not computed in eval mode; an ImagePoolingAttn's effect is the text
        self.dead = frozenset(s.i for s in specs[:-1] if s.i not in read and s.module != "ImagePoolingAttn")
        self.world = any(s.module in TEXT_MODULES for s in specs)

    @staticmethod
    def to_nchw(x: torch.Tensor, input_layout: str = "NCHW") -> torch.Tensor:
        """The model's (B, C, H, W) input from one of the JAX package's input layouts
        (`lpc_yolo_tpu/nn/compiler.py:723-737`), any dtype.

        "NHWC" (B, H, W, C) becomes a permuted view (channels_last memory).
        "WPACK" is the width-packed x8 feed (B, H, W/8, 8*C): it is unpacked
        8 -> 1 by the repack kernel, then viewed the same way.
        """
        if input_layout == "NCHW":
            return x
        if input_layout == "WPACK":
            x = repack_width_kernel(x, 8, 1)
        elif input_layout != "NHWC":
            raise ValueError(f"unknown input_layout {input_layout!r}")
        return x.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, branches: str = "both", input_layout: str = "NCHW", dn=None,
                text: Optional[torch.Tensor] = None, grid=None):
        x = self.to_nchw(x, input_layout)
        y: Dict[int, torch.Tensor] = {}
        if self.world and text is None:  # the structural default, for the stride probe (JAX :738-743)
            text = torch.zeros(x.shape[0], self.nc, TEXT_DIM, device=x.device)
        txt = text  # the running text, which an ImagePoolingAttn replaces; WorldDetect reads the original
        for spec, module in zip(self.specs, self.model):
            dead = spec.i in self.dead
            if dead and not self.training:
                continue
            if spec.module == "Classify":
                logits = module(x if spec.f[0] == -1 else y[spec.f[0]])
                return logits if self.training else {"probs": torch.softmax(logits.float(), -1), "logits": logits}
            if spec.module in ("Concat", "CBFuse", "ImagePoolingAttn", *R.MULTI_INPUT) or spec.module in HEAD_TASKS:
                inp = [x if j == -1 else y[j] for j in spec.f]
            else:
                inp = x if spec.f[0] == -1 else y[spec.f[0]]
            if spec.module == "v10Detect":
                return module(inp, branches=branches)
            if spec.module == "RTDETRDecoder":  # train mode: the DETR loss's dict (JAX :887-898)
                return module(inp, dn=dn) if self.training else {"pred": module(inp)}
            if spec.module == "Detect":
                return module(inp)
            if spec.module == "WorldDetect":
                return module(inp, text)
            if spec.module == "ImagePoolingAttn":  # x passes through (JAX :812-822)
                txt = module(inp, txt)
                if spec.i in self.save:
                    y[spec.i] = x
                continue
            if spec.module == "Segment":
                feats, mc, proto = module(inp)
                out = {"feats": feats, "mc": mc, "proto": proto}
                if not self.training:
                    out["pred"] = decode_feats(feats, self.strides, self.nc, self.reg_max, grid)
                return out
            if spec.module == "Pose":
                feats, kpt = module(inp)
                if self.training:
                    return {"feats": feats, "kpt_raw": kpt}
                shapes = [(cm.shape[2], cm.shape[3]) for _, cm in feats]
                return {"feats": feats, "pred": decode_feats(feats, self.strides, self.nc, self.reg_max, grid),
                        "kpt": decode_kpts(kpt, shapes, self.strides, module.kpt_shape, grid)}
            if spec.module == "OBB":
                feats, angle = module(inp)
                out = {"feats": feats, "angle": angle}
                if not self.training:
                    out["pred"] = decode_feats_obb(feats, angle, self.strides, self.nc, self.reg_max, grid)
                return out
            if dead:  # train mode: only its BatchNorm statistics are wanted
                with torch.no_grad():
                    module(inp)
                continue
            x = module(inp, txt) if spec.module == "C2fAttn" else module(inp)
            if spec.i in self.save:
                y[spec.i] = x
        return x  # headless graph

    def predict(self, x: torch.Tensor, max_det: int = 300, conf: float = 0.25, iou: float = 0.45,
                multi_label: bool = False, text: Optional[torch.Tensor] = None):
        """(B, max_det, 6) detections; `conf`, `iou` and `multi_label` are the NMS's and are
        not read by v10Detect's decode (the caller filters its rows by conf). A Segment model
        returns (detections, each row's mask coefficients (B, max_det, nm) gathered by its
        anchor as the JAX predictor does (:328-331), the prototypes (B, nm, H/4, W/4)); the masks
        are decoded by the caller for the rows it keeps (`ops/masks.py::process_mask`). A Pose model
        returns (detections, each row's decoded keypoints (B, max_det, nk) f32 in letterbox pixels,
        gathered by its anchor as the JAX predictor does, :175-180). An OBB model returns (B, max_det, 7)
        [cx, cy, w, h, angle, score, label] rows from `nms_rotated` (the JAX predictor :181-190 and validator
        :110-127; invalid rows 0 with label -1). A Classify model returns its probabilities (B, nc) f32. An
        RT-DETR model returns (B, nq, 6) rows with no NMS, as the JAX predictor decodes them (:166-174): the boxes
        cxcywh -> xyxy times the (square) input's size, the best score and its class; only x is read. A World model
        reads `text` (B, M, 512) and decodes M classes through the NMS (the JAX predictor :154-159), as a Detect model
        does its nc."""
        if self.task == "classify":
            return self.forward(x)["probs"]
        if self.task == "rtdetr":
            pred = self.forward(x)["pred"]
            best, label = pred[..., 4:].max(-1)
            return torch.cat([xywh2xyxy(pred[..., :4]) * x.shape[-1], best[..., None], label[..., None].float()], -1)
        if self.task == "obb":
            pred = self.forward(x)["pred"]
            rb = torch.cat([pred[..., :4], pred[..., -1:]], -1)
            return nms_rotated(rb, pred[..., 4:4 + self.nc], conf, iou, max_det, multi_label=multi_label)
        if self.task in ("segment", "pose"):
            out = self.forward(x)
            det, anchor = non_max_suppression(out["pred"], conf, iou, max_det, multi_label=multi_label,
                                              return_anchor_idx=True)
            extra = out["mc"] if self.task == "segment" else out["kpt"]
            rows = extra.gather(1, anchor.long()[..., None].expand(-1, -1, extra.shape[-1]))
            return (det, rows, out["proto"]) if self.task == "segment" else (det, rows)
        if self.task in ("v8", "world"):
            feats = self.forward(x, text=text)
            pred = decode_feats(feats, self.strides, feats[0][1].shape[1], self.reg_max)
            return non_max_suppression(pred, conf, iou, max_det, multi_label=multi_label)
        pairs = self.forward(x, branches="one2one")["one2one"]
        return decode_feats_topk_split(pairs, self.strides, self.nc, self.reg_max, max_det)


def _infer_strides(specs, save, nc, ch: int = 3, probe: int = 256) -> Tuple[float, ...]:
    """Output strides from a forward on the meta device (shapes only, no FLOPs), one per head level
    (2 for v3-tiny, 4 for the P2 and P6 graphs). The graph runs in train mode, as the JAX probe does
    (:1031-1042): in eval mode a head would decode its levels with the default strides. An RT-DETR graph is not
    probed: its decoder has no strides (and no train branch here), and the JAX probe finds none (:1041-1044)."""
    if specs and specs[-1].module == "RTDETRDecoder":
        return (8.0, 16.0, 32.0)
    with torch.device("meta"):
        m = DetectionModel(specs, save, nc).train()
        feats = m(torch.zeros(1, ch, probe, probe), branches="one2many")
    if isinstance(feats, dict):
        feats = feats["feats"] if "feats" in feats else feats["one2many"]
    elif not isinstance(feats, list):  # a headless or classify graph (JAX :1044)
        return (8.0, 16.0, 32.0)
    return tuple(float(probe / cm.shape[2]) for _, cm in feats)


def build_model(cfg: Union[str, Path, Dict], device: Union[str, torch.device, None] = None,
                nc: Optional[int] = None) -> DetectionModel:
    """Build a DetectionModel (f32, eval mode) from a YAML path or dict, strides resolved;
    `nc` overrides the YAML's class count; the YAML's `activation:` key (nn.ReLU(), nn.SiLU() or
    nn.Mish()) sets the conv.py family's default activation, as the JAX `build_model` reads it.

    It lands on CUDA unless the caller passes device="cpu" (see `resolve_device`).
    """
    device = resolve_device(device)
    d = yaml_model_load(cfg) if not isinstance(cfg, dict) else dict(cfg)
    if nc is not None:
        d["nc"] = nc
    act = str(d.get("activation", "nn.SiLU()")).strip()
    if act not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {act!r} is not ported (the port takes {sorted(_ACTIVATIONS)})")
    act = _ACTIVATIONS[act]
    specs, save = parse_model(d)
    strides = _infer_strides(specs, save, d["nc"])
    with torch.device(device):
        model = DetectionModel(specs, save, d["nc"], strides, default_act=act)
    return model.eval()
