"""The port's ONNX and TorchScript artifacts of yolov8n, -seg, -pose, -obb and -cls (`engine/exporter.py`,
`engine/onnx_export.py`, `nn/autobackend.py`), on the CPU at imgsz 64, nc 3, in the JAX layouts: `pred`
(B, A, 4 + nc [+ 1 angle]), seg `mc` (B, A, nm) and `proto` (B, Hp, Wp, nm) NHWC, pose `kpt` (B, A, 51) in
letterbox px, classify `probs`. Each output is held to the JAX graph's `apply(..., input_layout="NCHW")` on the
same weights (the JAX export's outputs, `lpc_yolo_tpu/engine/exporter.py::_task_outputs`), and to the port's own
f32 forward. ONNX runs through OpenCV's dnn module, TorchScript through `torch.jit.load`, both through the JAX
AutoBackend and the port's. Weights as in `tests/test_torch_export.py`, whose helpers live here.
"""

import re

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cv2
import jax
from lpc_yolo_tpu.engine.model import _resolve_yaml
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from lpc_yolo_tpu.nn.compiler import yaml_model_load

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine.exporter import OUT_DESC, export_model
from lpc_yolo_tpu_torch.nn.autobackend import AutoBackend
from lpc_yolo_tpu_torch.nn.heads import decode_feats
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, random_variables

S, NC = 64, 3
TOL = {"atol": 5e-4, "rtol": 1e-3}  # tests/test_onnx.py:78
TASKS = {"yolov8n.yaml": ["pred"], "yolov8n-seg.yaml": ["pred", "mc", "proto"], "yolov8n-pose.yaml": ["pred", "kpt"],
         "yolov8n-obb.yaml": ["pred"], "yolov8n-cls.yaml": ["probs"]}
A = 84  # anchors at 64: 8^2 + 4^2 + 2^2
SHAPES = {"yolov8n.yaml": [(1, A, 4 + NC)], "yolov8n-seg.yaml": [(1, A, 4 + NC), (1, A, 32), (1, 16, 16, 32)],
          "yolov8n-pose.yaml": [(1, A, 4 + NC), (1, A, 51)], "yolov8n-obb.yaml": [(1, A, 4 + NC + 1)],
          "yolov8n-cls.yaml": [(1, NC)]}


def perturbed(shapes, seed: int = 0, scale: float = 0.02):
    """`random_variables` of a shape tree plus scale * N(0, 1) on every leaf in order (the JAX `_perturb`),
    so no two anchors' scores tie."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t + (scale * rng.standard_normal(t.shape)).astype(t.dtype)

    return walk(random_variables(shapes, seed))


def port_yolo(name: str):
    """The port's facade of `name` at nc 3 on the CPU, with perturbed weights through the bridge; and them."""
    yolo = YOLO(name, device="cpu", nc=NC, seed=None)
    variables = perturbed(flax_shapes(yolo.model))
    return yolo.load_flax(variables), variables


def canon(det):
    """Rows in a canonical order (lexsorted on every column), for detections ranked by different runtimes."""
    return det[:, np.lexsort(det[0].T[::-1]), :]


def device_constants(mod):
    """The `prim::Constant[value="cpu"]` Device lines of a TorchScript module's inlined graph."""
    return [line for line in str(mod.inlined_graph).splitlines() if 'prim::Constant[value="cpu"]' in line]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_outputs(yolo, x: np.ndarray):
    """The port's f32 eval forward (BatchNorm unfolded) of an NCHW batch, in the artifact's outputs and layouts."""
    m = yolo.model
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    outs = {"v8": lambda: [decode_feats(out, m.strides, m.nc, m.reg_max)],
            "segment": lambda: [out["pred"], out["mc"], out["proto"].permute(0, 2, 3, 1)],
            "pose": lambda: [out["pred"], out["kpt"]], "obb": lambda: [out["pred"]],
            "classify": lambda: [out["probs"]]}[m.task]()
    return [o.numpy() for o in outs]


def jax_outputs(name: str, variables, x: np.ndarray):
    """The JAX graph of `name` at nc 3, jitted once, on an NCHW batch: the outputs its export carries, in their
    layouts (`lpc_yolo_tpu/engine/exporter.py::client_fn`)."""
    d = yaml_model_load(_resolve_yaml(name))
    d["scale"] = re.search(r"yolov\d+([nsmblx])", name).group(1)
    jm = jax_build(d, nc=NC)
    fn = jax.jit(lambda v, im: tuple(jm.apply(v, im, training=False, input_layout="NCHW")[k] for k in TASKS[name]))
    return [np.asarray(o) for o in fn(variables, x)]


@pytest.fixture(scope="module", params=list(TASKS))
def artifacts(request, tmp_path_factory):
    name = request.param
    yolo, variables = port_yolo(name)
    out = tmp_path_factory.mktemp(Path(name).stem)
    x = np.random.default_rng(7).random((1, 3, S, S), dtype=np.float32)
    return SimpleNamespace(name=name, yolo=yolo, x=x, ref=port_outputs(yolo, x), jref=jax_outputs(name, variables, x),
                           onnx=export_model(yolo, "onnx", imgsz=S, out_dir=out),
                           ts=export_model(yolo, "torchscript", imgsz=S, out_dir=out))


def onnx_run(a):
    """The ONNX artifact through OpenCV's runtime, after its sidecar is checked (the JAX keys and the node
    count)."""
    names = TASKS[a.name]
    sidecar = json.loads(Path(a.onnx + ".json").read_text())
    nodes = sidecar.pop("nodes")
    assert sidecar == {"input": [1, 3, S, S], "input_layout": "NCHW fp32 [0,1]", "outputs": names, "nc": NC,
                       "output": {k: OUT_DESC[k] for k in names}}
    blob = Path(a.onnx).read_bytes()  # node i is named n<i>_<op>
    assert f"n{nodes - 1}_Identity".encode() in blob and f"n{nodes}_".encode() not in blob
    net = cv2.dnn.readNetFromONNX(a.onnx)
    net.setInput(a.x, "images")
    return net.forward(names)


def torchscript_run(a):
    """The TorchScript artifact through `torch.jit.load` on the CPU, after its config (the JAX keys and the
    names) is checked and its graph is found to hold no CPU Device constant (its anchors are buffers that
    `map_location` moves)."""
    extra = {"config.txt": ""}
    mod = torch.jit.load(a.ts, _extra_files=extra)
    assert device_constants(mod) == []
    meta = json.loads(extra["config.txt"])
    assert (meta["outputs"], meta["nc"], meta["input"]) == (TASKS[a.name], NC, [1, 3, S, S])
    assert meta["names"] == {str(k): v for k, v in a.yolo.names.items()}
    with torch.no_grad():
        got = mod(torch.from_numpy(a.x))
    return [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]


def assert_outputs(got, ref, name):
    assert [g.shape for g in got] == [r.shape for r in ref] == SHAPES[name]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **TOL)


def test_onnx_matches_jax(artifacts):
    """Every output of the ONNX artifact through OpenCV against the JAX graph's, name by name and layout by
    layout."""
    assert_outputs(onnx_run(artifacts), artifacts.jref, artifacts.name)


def test_torchscript_matches_jax(artifacts):
    assert_outputs(torchscript_run(artifacts), artifacts.jref, artifacts.name)


def test_onnx_matches_the_port(artifacts):
    assert_outputs(onnx_run(artifacts), artifacts.ref, artifacts.name)


def test_torchscript_matches_the_port(artifacts):
    """The traced graph on the CPU against the port's forward."""
    assert_outputs(torchscript_run(artifacts), artifacts.ref, artifacts.name)


def test_both_autobackends_read_the_artifacts(artifacts):
    """The JAX AutoBackend and the port's read each ONNX and TorchScript artifact: a raw detect map decoded on
    the host to equal (B, 300, 6) detections, seg and pose as dicts of equal named outputs. The JAX AutoBackend
    sends an OBB map and a classifier's probabilities to the detect decode, which asserts (ROADMAP Queue 3); the
    port's gives them back as the artifact gives them."""
    a = artifacts
    x = np.ascontiguousarray(a.x.transpose(0, 2, 3, 1))
    for path in (a.onnx, a.ts):
        got = AutoBackend(path, imgsz=S, device="cpu")(x)
        if a.name in ("yolov8n-obb.yaml", "yolov8n-cls.yaml"):
            with pytest.raises(AssertionError):
                JaxAutoBackend(path, imgsz=S).forward(x)
            np.testing.assert_allclose(got, a.ref[0], **TOL)
            continue
        ref = JaxAutoBackend(path, imgsz=S).forward(x)
        if isinstance(ref, dict):
            assert set(got) == set(ref) == set(TASKS[a.name])
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-6)
        else:
            assert got.shape == ref.shape == (1, 300, 6)
            np.testing.assert_allclose(canon(got), canon(ref), atol=1e-5, rtol=1e-5)
