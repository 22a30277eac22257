"""Export: ONNX, TorchScript and `.ckpt` artifacts of a model (counterpart of `lpc_yolo_tpu/engine/exporter.py`).

The contract is the JAX package's: an ONNX or TorchScript artifact takes one f32 NCHW batch in [0, 1] (the
frame's /255 is not folded into it) and gives the JAX outputs in the JAX layouts (`_task_outputs`): a v10 head
decodes in the graph to `det` (B, max_det, 6) unless `raw_head`; every other head gives its `pred` map
(B, A, 4 + nc [+ extras]), a Segment head also `mc` (B, A, nm) and `proto` (B, Hp, Wp, nm) NHWC, a Pose head
`kpt` (B, A, nk * 3), a Classify head `probs`. The ONNX file carries a `.onnx.json` sidecar, the TorchScript
file `_extra_files["config.txt"]`, both with the JAX keys (the sidecar also with the graph's node count,
`nodes`). A `.ckpt` is `YOLO.save`'s file with the JAX meta
(`imgsz`, `nc`, `task`, `model_yaml`, `names`), which `YOLO(path)` of either package reads.

The export graph (`ExportGraph`) is a CPU copy of the model with its BatchNorms folded in f32 and no int8
(the JAX package exports its f32 graph after `quantize_int8` too: its quantization acts only on its deploy
graph). Both traces run on the CPU, where every kernel wrapper runs its plain PyTorch version, so an artifact
is a portable plain graph: standard Conv nodes, no hand-written kernel, which a runtime without this package
could not load. The 3x3 sites' plain version views each map NHWC; the ONNX writer cancels those transposes,
and in TorchScript they are views. The anchors, strides and DFL bins of the static input shape are buffers of
the graph, so a TorchScript artifact loaded with `map_location="cuda"` finds them on the card; a traced graph
that still holds a device constant is refused.

`stablehlo` needs `torch_xla`, and the TensorFlow family (`saved_model`, `pb`, `tflite`, `tflite-int8`) an
ATen -> TensorFlow route over the same graph walk: both raise NotImplementedError naming what is missing, as
the six `UNSUPPORTED` formats raise as the JAX package raises them.
"""

from __future__ import annotations

import copy
import json
import math
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..nn.fuse import folded_convs, fuse_conv_bn
from ..nn.heads import decode_feats
from ..ops.anchors import Grid, make_grid
from ..ops.postprocess import v10_detections
from ..utils.checkpoint import save_checkpoint
from ..utils.flax_bridge import state_dict_to_flax

EXPORT_FORMATS = {
    "ckpt": "flax msgpack checkpoint (native; YOLO.save's file with the export meta)",
    "stablehlo": "StableHLO serialized module (not in the port: needs torch_xla)",
    "saved_model": "TensorFlow SavedModel (not in the port yet)",
    "tflite": "TFLite flatbuffer (not in the port yet)",
    "tflite-int8": "TFLite int8 full-integer quantization (not in the port yet)",
    "onnx": "ONNX graph (torch.export graph -> ONNX converter; in-graph v10 decode, raw_head=True opts out)",
    "torchscript": "TorchScript module (torch.jit.trace of the export graph; in-graph v10 decode, raw_head=True "
                   "opts out)",
    "pb": "TensorFlow GraphDef frozen graph (not in the port yet)",
}
UNSUPPORTED = {
    "engine": "TensorRT targets NVIDIA GPUs; use stablehlo/tflite for TPU-adjacent deploys",
    "coreml": "coremltools not available",
    "paddle": "paddle toolchain not available",
    "ncnn": "ncnn toolchain not available",
    "edgetpu": "edgetpu_compiler not available",
    "tfjs": "tensorflowjs not available",
}
NOT_PORTED = {
    "stablehlo": "StableHLO from PyTorch needs torch_xla, which is not installed (ROADMAP: not queueable)",
    **{fmt: "the TensorFlow family needs an ATen -> TensorFlow route over the export graph walk, a later slice "
            "of the port (ROADMAP Queue 1)" for fmt in ("saved_model", "pb", "tflite", "tflite-int8")},
}
OUT_DESC = {
    "pred": "pred (B, anchors, 4+nc[+extras]) xyxy + sigmoid scores",
    "mc": "mask coefficients (B, anchors, nm)",
    "proto": "mask prototypes (B, Hp, Wp, nm) NHWC",
    "kpt": "decoded keypoints (B, anchors, nk*3) letterbox px",
    "probs": "softmax class probabilities (B, nc)",
}


def _task_outputs(model) -> List[str]:
    """The output names an artifact carries, by head (JAX :43-60): Segment pred, mc, proto; Pose pred, kpt;
    Classify probs; every other head pred (an OBB head's angle rides as its last column)."""
    head = model.specs[-1].module if getattr(model, "specs", None) else ""
    return {"Segment": ["pred", "mc", "proto"], "Pose": ["pred", "kpt"], "Classify": ["probs"]}.get(head, ["pred"])


def _drop_unfolded(model: nn.Module) -> None:
    """Take out the conv and BatchNorm tensors that a folded conv no longer reads, so that the artifact holds
    each weight once (its folded form)."""
    for conv in folded_convs(model):
        for m in conv.modules():
            for name in list(m._parameters):
                m.register_parameter(name, None)
            for name in list(m._buffers):
                m.register_buffer(name, None)


class ExportGraph(nn.Module):
    """What an ONNX or TorchScript artifact computes: f32 NCHW [0, 1] (batch, 3, S, S) -> the JAX outputs.

    `model` is a BN-folded f32 CPU copy; `decode` puts the v10 NMS-free decode in the graph (`v10_detections`
    ranked by `torch.topk`: an ONNX TopK, whose ties go to the lower index). The grid of the head's levels at S is
    held as buffers.
    """

    def __init__(self, model: nn.Module, imgsz: int, max_det: int = 300, decode: bool = False, text=None):
        super().__init__()
        self.model, self.max_det, self.decode = model, max_det, decode
        if model.task == "world":  # the class set's text table that `predict` reads, (1, M, 512)
            self.register_buffer("text", torch.as_tensor(np.asarray(text, np.float32)))
        self.names = ["det"] if decode else _task_outputs(model)
        if model.task not in ("classify", "rtdetr"):
            # the levels' maps are S / stride on a side (ceil, as a same-padded stride-2 conv)
            shapes = [(math.ceil(imgsz / s),) * 2 for s in model.strides]
            grid = make_grid(shapes, model.strides, model.reg_max)
            self.register_buffer("points", grid.points)
            self.register_buffer("stride_tensor", grid.strides)
            self.register_buffer("bins", grid.bins)

    def forward(self, x: torch.Tensor):
        m = self.model
        if m.task == "classify":
            return m(x)["probs"]
        if m.task == "rtdetr":
            return m(x)["pred"]
        grid = Grid(self.points, self.stride_tensor, self.bins)
        if m.task in ("segment", "pose", "obb"):
            out = m(x, grid=grid)
            if m.task == "segment":
                return out["pred"], out["mc"], out["proto"].permute(0, 2, 3, 1)
            return (out["pred"], out["kpt"]) if m.task == "pose" else out["pred"]
        if m.task == "world":
            feats = m(x, text=self.text.expand(x.shape[0], -1, -1))
        else:
            feats = m(x, branches="one2one")["one2one"] if m.task == "v10" else m(x)
        pred = decode_feats(feats, m.strides, feats[0][1].shape[1], m.reg_max, grid)
        if self.decode:
            return v10_detections(pred, self.max_det, m.nc, rank=lambda t, k: t.topk(k, dim=1))
        return pred


def export_graph(yolo, imgsz: int, max_det: int = 300, raw_head: bool = False) -> ExportGraph:
    """The facade's model as an `ExportGraph`: a CPU f32 copy, BN folded, no int8, unfolded tensors dropped."""
    model = copy.deepcopy(yolo.model).cpu().float().eval()
    fuse_conv_bn(model, torch.float32)
    _drop_unfolded(model)
    return ExportGraph(model, imgsz, max_det, decode=model.task == "v10" and not raw_head,
                       text=getattr(yolo, "txt_feats", None)).eval()


def _device_constants(traced) -> List[str]:
    """The Device constants a traced graph holds (a tensor made on the tracing device, not moved with it)."""
    return [str(n).strip() for n in traced.inlined_graph.nodes()
            if n.kind() == "prim::Constant" and n.output().type().kind() == "DeviceObjType"]


def export_model(yolo, fmt: str = "tflite", imgsz: int = 640, batch: int = 1, out_dir: Optional[str] = None,
                 int8_calibration: Optional[np.ndarray] = None, max_det: int = 300, raw_head: bool = False) -> str:
    """Export the facade's model; returns the artifact's path (JAX :94-331). `raw_head` opts a v10 artifact out
    of the in-graph decode: it gives the raw `pred` map. `int8_calibration` is read by tflite-int8 alone, which
    raises here."""
    fmt = "tflite-int8" if fmt == "int8" else str(fmt).lower()
    if fmt in UNSUPPORTED:
        raise NotImplementedError(f"export format '{fmt}': {UNSUPPORTED[fmt]}")
    if fmt not in EXPORT_FORMATS:
        raise ValueError(f"unknown export format '{fmt}'; choose from {list(EXPORT_FORMATS)}")
    if fmt in NOT_PORTED:
        raise NotImplementedError(f"export format '{fmt}' is not ported: {NOT_PORTED[fmt]}")

    out_dir = Path(out_dir or "runs/export")
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(str(yolo.ckpt_path)).stem
    model = yolo.model
    if fmt == "ckpt":
        path = out_dir / f"{stem}.ckpt"
        meta = {"imgsz": imgsz, "nc": model.nc, "task": yolo.task, "model_yaml": yolo.model_yaml,
                "names": yolo.names}
        save_checkpoint(path, state_dict_to_flax(model.state_dict()), meta)
        return str(path)

    graph = export_graph(yolo, imgsz, max_det, raw_head)
    example = torch.rand(batch, 3, imgsz, imgsz, generator=torch.Generator().manual_seed(0))
    names = graph.names
    desc = (f"det (B, {max_det}, 6) = [x1,y1,x2,y2,score,label] (in-graph NMS-free decode)" if graph.decode
            else {k: OUT_DESC[k] for k in names})
    meta: Dict = {"input": [batch, 3, imgsz, imgsz], "input_layout": "NCHW fp32 [0,1]", "output": desc,
                  "outputs": names, "nc": model.nc}
    if fmt == "onnx":
        from .onnx_export import export_onnx

        path = out_dir / f"{stem}.onnx"
        nodes = export_onnx(graph, example, str(path), output_names=names, graph_name=stem)
        (out_dir / f"{stem}.onnx.json").write_text(json.dumps({**meta, "nodes": nodes}))
        return str(path)

    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(graph, example, check_trace=False)
    consts = _device_constants(traced)
    if consts:
        raise NotImplementedError(f"TorchScript export of a {model.task} graph: the traced graph makes tensors on "
                                  f"the tracing device ({consts[0]}), which map_location does not move")
    path = out_dir / f"{stem}.torchscript"
    torch.jit.save(traced, str(path), _extra_files={"config.txt": json.dumps({**meta, "names": yolo.names})})
    return str(path)
