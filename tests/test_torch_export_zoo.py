"""The port's ONNX and TorchScript artifacts of the families beyond the task heads, on the CPU at imgsz 64, nc 3:
YOLO-World v2 (its class text held in the graph) and one LPC-YOLO variant each from the research zoo's attention
(ParNetAttention), neck (slimneck: GSConv, VoV-GSCSP) and backbone (FasterNet) families. Each artifact's raw
`pred` map through OpenCV's dnn module and through `torch.jit.load` is held to the port's own f32 forward of the
model (BatchNorm unfolded), which `tests/test_torch_world.py`, `test_torch_research*.py`, `test_torch_neck*.py`
and `test_torch_backbone*.py` hold to the JAX package. The seeded weights of `YOLO(cfg, seed=0)`.
"""

import numpy as np
import pytest
import torch

import cv2

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine.exporter import export_model
from lpc_yolo_tpu_torch.nn import research
from lpc_yolo_tpu_torch.nn.heads import decode_feats

from test_torch_export_tasks import NC, S, TOL, device_constants

A = 84  # anchors at 64: 8^2 + 4^2 + 2^2
MODELS = {
    "yolov8n-worldv2.yaml": lambda tmp: "yolov8n-worldv2.yaml",
    "attention-ParNetAttention": lambda tmp: research.write_lpc_attention_yaml("ParNetAttention", tmp),
    "neck-slimneck": lambda tmp: research.write_lpc_neck_yaml("slimneck", tmp),
    "backbone-fasternet": lambda tmp: research.write_lpc_backbone_yaml("fasternet", tmp),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def forward_pred(yolo, x: np.ndarray) -> np.ndarray:
    """The model's f32 eval forward of an NCHW batch, decoded to the artifact's raw `pred` (B, A, 4 + nc): a v10
    head's one-to-one branch, World's with the facade's class text."""
    m = yolo.model
    with torch.no_grad():
        if m.task == "world":
            feats = m(torch.from_numpy(x), text=torch.as_tensor(np.asarray(yolo.txt_feats, np.float32)))
        else:
            feats = m(torch.from_numpy(x), branches="one2one")["one2one"]
        return decode_feats(feats, m.strides, m.nc, m.reg_max).numpy()


@pytest.mark.parametrize("key", list(MODELS))
def test_onnx_and_torchscript_match_the_forward(key, tmp_path):
    yolo = YOLO(MODELS[key](tmp_path), device="cpu", nc=NC, seed=0)
    assert yolo.task == ("world" if key.startswith("yolov8") else "v10")
    x = np.random.default_rng(8).random((1, 3, S, S), dtype=np.float32)
    ref = forward_pred(yolo, x)
    assert ref.shape == (1, A, 4 + NC)
    onnx = export_model(yolo, "onnx", imgsz=S, out_dir=tmp_path, raw_head=True)
    net = cv2.dnn.readNetFromONNX(onnx)
    net.setInput(x, "images")
    got, = net.forward(["pred"])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    mod = torch.jit.load(export_model(yolo, "torchscript", imgsz=S, out_dir=tmp_path, raw_head=True))
    assert device_constants(mod) == []
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
