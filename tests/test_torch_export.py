"""Export of the port (`lpc_yolo_tpu_torch/engine/{exporter,onnx_export}.py`, `nn/autobackend.py`) against the JAX
package's contract (`lpc_yolo_tpu/engine/exporter.py`, `nn/autobackend.py`), on the CPU at imgsz 64, nc 3.

Weights come from `random_variables` over the port's shape tree, perturbed once as the JAX `_perturb`
(`tests/test_onnx.py`) does, and reach both packages through the bridge. OpenCV's dnn module is the
independent runtime of every ONNX artifact, as in the JAX package's tests.

* LPC-YOLO's raw ONNX through `cv2.dnn` against the JAX `model.apply(..., input_layout="NCHW")["pred"]`
  (atol 5e-4, rtol 1e-3, `tests/test_onnx.py:78`), with the JAX sidecar; its `.ckpt` read by the JAX `YOLO` and
  the port's (the same variables bit for bit, the same map); an int8-quantized copy's artifact byte-equal to it.
* yolov10n's decoded ONNX against the JAX `v10_detections` of the same runtime's raw map (canonical row order,
  1e-5); its TorchScript read by both packages' AutoBackend with equal detections; no Device constant in it.
* Every format the port does not write raises NotImplementedError with its reason, an unknown one ValueError;
  an ATen target with no emitter raises naming it.

`tests/test_torch_export_tasks.py` holds the v8 detect, seg, pose, OBB and classify artifacts.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
import lpc_yolo_tpu.engine.model as jax_model
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from lpc_yolo_tpu.ops.postprocess import v10_detections as jax_v10_detections

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import exporter as E
from lpc_yolo_tpu_torch.engine.onnx_export import export_onnx
from lpc_yolo_tpu_torch.nn.autobackend import AutoBackend
from lpc_yolo_tpu_torch.ops.conv3x3 import apply_act
from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

from test_torch_export_tasks import NC, S, canon, device_constants, port_yolo

ROOT = Path(__file__).resolve().parents[1]
JAX_V10 = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v10"
LPC = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The graphs are small: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_forward(path, x, names):
    net = cv2.dnn.readNetFromONNX(str(path))
    net.setInput(x, "images")
    return net.forward(names)


@pytest.fixture(scope="module")
def lpc(tmp_path_factory):
    """LPC-YOLO at full width: the port's facade, its variables, the JAX graph's jitted NCHW `pred`, and its raw
    ONNX artifact."""
    yolo, variables = port_yolo(LPC)
    jm = jax_build(JAX_V10 / LPC, nc=NC)
    jpred = jax.jit(lambda v, x: jm.apply(v, x, training=False, input_layout="NCHW")["pred"])
    out = tmp_path_factory.mktemp("lpc")
    onnx = E.export_model(yolo, "onnx", imgsz=S, out_dir=out, raw_head=True)
    return SimpleNamespace(yolo=yolo, variables=variables, jpred=jpred, onnx=onnx, out=out)


def test_lpc_onnx_matches_jax(lpc):
    """The fork's namesake (space_to_depth, SPDConv, SPCA, LPC, CBAM, PSA) through OpenCV's runtime against the
    JAX graph on the same weights; the sidecar carries the JAX keys; every 3x3 site is a plain Conv node between
    NCHW tensors (the plain version's NHWC views cancel)."""
    x = np.random.default_rng(0).random((1, 3, S, S), dtype=np.float32)
    got, = cv2_forward(lpc.onnx, x, ["pred"])
    ref = np.asarray(lpc.jpred(lpc.variables, x))
    assert got.shape == ref.shape == (1, 84, 4 + NC)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    assert Path(lpc.onnx).name == Path(LPC).stem + ".onnx"
    sidecar = json.loads(Path(lpc.onnx + ".json").read_text())
    nodes = sidecar.pop("nodes")
    assert sidecar == {"input": [1, 3, S, S], "input_layout": "NCHW fp32 [0,1]", "outputs": ["pred"], "nc": NC,
                       "output": {"pred": E.OUT_DESC["pred"]}}
    blob = Path(lpc.onnx).read_bytes()
    assert blob.count(b"\x22\x09Transpose") <= 6 and blob.count(b"\x22\x04Conv") == 88  # the op_type fields
    assert f"n{nodes - 1}_Identity".encode() in blob and f"n{nodes}_".encode() not in blob  # node i is n<i>_<op>


def test_ckpt_is_read_by_both_packages(lpc, monkeypatch):
    """`export(format="ckpt")` writes the JAX meta; the JAX `YOLO(path)` reads the port's variables bit for bit
    and gives the map the JAX graph gives, the port's `YOLO(path)` the same state_dict."""
    path = E.export_model(lpc.yolo, "ckpt", imgsz=S, out_dir=lpc.out)
    with open(path, "rb") as f:
        meta = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert list(meta) == ["imgsz", "nc", "task", "model_yaml", "names"] and (meta["imgsz"], meta["task"]) == (S, "v10")
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: lpc.variables)  # the load template; no init compile
    jy = jax_model.YOLO(path)
    assert (jy.model.nc, jy.task, jy.names) == (NC, "v10", lpc.yolo.names)
    ref = state_dict_to_flax(lpc.yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(ref[col]),
                                    jax.tree_util.tree_leaves_with_path(jax.device_get(jy.variables[col]))):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    x = np.random.default_rng(1).random((1, 3, S, S), dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(lpc.jpred(jy.variables, x)), np.asarray(lpc.jpred(lpc.variables, x)))
    back = YOLO(path, device="cpu")
    a, b = back.model.state_dict(), lpc.yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_int8_model_exports_the_f32_graph(lpc, tmp_path):
    """After `quantize_int8` the artifact is the unquantized one, byte for byte: the JAX package exports its f32
    graph after quantization too, and the int8 scales act only on the serving copy."""
    rng = np.random.default_rng(4)
    lpc.yolo.quantize_int8([rng.integers(0, 256, (S, S, 3), dtype=np.uint8) for _ in range(2)], imgsz=S, batch=2)
    try:
        assert lpc.yolo.model.int8_scales
        path = E.export_model(lpc.yolo, "onnx", imgsz=S, out_dir=tmp_path, raw_head=True)
    finally:
        del lpc.yolo.model.int8_scales
    assert Path(path).read_bytes() == Path(lpc.onnx).read_bytes()


@pytest.fixture(scope="module")
def v10n(tmp_path_factory):
    """yolov10n: its decoded and raw ONNX and its decoded TorchScript."""
    yolo, _ = port_yolo("yolov10n.yaml")
    out = tmp_path_factory.mktemp("v10n")
    return SimpleNamespace(
        yolo=yolo, decoded=E.export_model(yolo, "onnx", imgsz=S, out_dir=out),
        raw=E.export_model(yolo, "onnx", imgsz=S, out_dir=out / "raw", raw_head=True),
        ts=E.export_model(yolo, "torchscript", imgsz=S, out_dir=out))


def test_v10n_decodes_in_graph(v10n):
    """The in-graph NMS-free decode (TopK, GatherElements, Mod, Div, Pad through OpenCV) against the JAX
    `v10_detections` of the same runtime's raw map: the same labels, the same detection set within 1e-5 (row
    order canonical: tied scores are ranked by the runtime); the sidecar names `det (B, 300, 6)`."""
    x = np.random.default_rng(2).random((1, 3, S, S), dtype=np.float32)
    det, = cv2_forward(v10n.decoded, x, ["det"])
    raw, = cv2_forward(v10n.raw, x, ["pred"])
    ref = np.asarray(jax_v10_detections(jnp.asarray(raw), 300, NC))
    assert det.shape == ref.shape == (1, 300, 6)
    assert (np.sort(det[0, :, 5]) == np.sort(ref[0, :, 5])).all()
    np.testing.assert_allclose(canon(det), canon(ref), atol=1e-5, rtol=1e-5)
    sidecar = json.loads(Path(v10n.decoded + ".json").read_text())
    assert sidecar["output"].startswith("det (B, 300, 6)") and sidecar["outputs"] == ["det"]


def test_both_autobackends_read_the_v10n_artifacts(v10n):
    """The JAX AutoBackend and the port's read the decoded ONNX and TorchScript artifacts and the raw ONNX (host
    decode) and give the same detections; the TorchScript holds no Device constant and its config the JAX keys."""
    x = np.random.default_rng(3).random((1, S, S, 3), dtype=np.float32)
    for path in (v10n.decoded, v10n.ts, v10n.raw):
        ours = AutoBackend(path, imgsz=S, device="cpu")
        got, ref = ours(x), JaxAutoBackend(path, imgsz=S).forward(x)
        assert got.shape == ref.shape == (1, 300, 6), path
        np.testing.assert_allclose(canon(got), canon(ref), atol=1e-5, rtol=1e-5)
        ours.warmup()
    extra = {"config.txt": ""}
    assert device_constants(torch.jit.load(v10n.ts, _extra_files=extra)) == []
    meta = json.loads(extra["config.txt"])
    assert meta["outputs"] == ["det"] and meta["nc"] == NC and meta["names"] == {str(i): str(i) for i in range(NC)}


@pytest.mark.parametrize("fmt", ["saved_model", "pb", "tflite", "tflite-int8", "int8", "stablehlo",
                                 *E.UNSUPPORTED, "nonsense"])
def test_formats_not_written_raise(fmt):
    """The TensorFlow family and stablehlo raise NotImplementedError with their reason, the six JAX `UNSUPPORTED`
    formats as the JAX package raises them, an unknown format ValueError, each before the model is read; the
    facade's default format is tflite."""
    model = SimpleNamespace()  # no attribute: nothing of a model is read before the refusal
    if fmt == "nonsense":
        with pytest.raises(ValueError, match="unknown export format"):
            YOLO.export(model, format=fmt, imgsz=S)
        return
    reason = {**E.UNSUPPORTED, **E.NOT_PORTED}["tflite-int8" if fmt == "int8" else fmt]
    with pytest.raises(NotImplementedError, match=reason.split(" (")[0].split(";")[0]):
        YOLO.export(model, format=fmt, imgsz=S)
    if fmt == "tflite":
        with pytest.raises(NotImplementedError, match="TensorFlow"):
            YOLO.export(model, imgsz=S)


def _affine(m):
    with torch.no_grad():
        for prm in m.parameters():
            prm.uniform_(-1, 1)
    return m.eval()


# one-op graphs over each emitter that the task graphs above do not reach (the zoo's and World's ops)
ONE_OP = {
    "softmax_axis1": lambda: lambda x: x.softmax(1),
    "bilinear": lambda: lambda x: torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear"),
    "bilinear_align_corners": lambda: lambda x: torch.nn.functional.interpolate(x, size=(9, 9), mode="bilinear",
                                                                               align_corners=True),
    "nearest_exact": lambda: lambda x: torch.nn.functional.interpolate(x, size=(9, 9), mode="nearest-exact"),
    "pixel_shuffle": lambda: lambda x: torch.nn.functional.pixel_shuffle(x, 2),
    "roll": lambda: lambda x: torch.roll(x, (2, -1), (2, 3)),
    "group_norm": lambda: _affine(torch.nn.GroupNorm(2, 4)),
    "layer_norm": lambda: _affine(torch.nn.LayerNorm(6)),
    "batch_norm": lambda: _affine(torch.nn.BatchNorm2d(4)),
    "sdpa_bool_mask": lambda: lambda x: torch.nn.functional.scaled_dot_product_attention(
        x, x * 0.5, x + 1, attn_mask=torch.ones(6, 6, dtype=torch.bool).tril()),
    "adaptive_max_pool": lambda: lambda x: torch.nn.functional.adaptive_max_pool2d(x, 4),
    "einsum": lambda: lambda x: torch.einsum("bchw,bdhw->bcd", x, x),
    "gelu_tanh": lambda: lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "gelu_erf": lambda: torch.nn.functional.gelu,
    "mish_chain_large": lambda: lambda x: apply_act(x * 200, "mish"),  # OpenCV's Tanh is NaN past |x| ~ 44
    "gelu_tanh_large": lambda: lambda x: torch.nn.functional.gelu(x * 200, approximate="tanh"),
    "avg_pool_count_pad": lambda: lambda x: torch.nn.functional.avg_pool2d(x, 3, 1, 1),
    "avg_pool_no_count_pad": lambda: lambda x: torch.nn.functional.avg_pool2d(x, 2, 1, 1, count_include_pad=False),
    "conv_transpose": lambda: _affine(torch.nn.ConvTranspose2d(4, 3, 2, 2)),
    "vector_norm": lambda: lambda x: x / torch.linalg.vector_norm(x, dim=1, keepdim=True),
    "std_biased": lambda: lambda x: x / torch.std(x, dim=(2, 3), keepdim=True, correction=0),
    "narrow_chunk_unbind": lambda: lambda x: torch.cat(x.narrow(1, 1, 2).chunk(2, 1) + (x.unbind(1)[3][:, None],), 1),
    "linear": lambda: _affine(torch.nn.Linear(6, 5)),
}


@pytest.mark.parametrize("op", list(ONE_OP))
def test_emitter_through_opencv(op, tmp_path):
    """Each emitter's ONNX nodes through OpenCV's runtime against torch, within 1e-5."""
    fn = ONE_OP[op]()

    class OneOp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fn = fn

        def forward(self, x):
            return self.fn(x)

    m = OneOp().eval()
    x = torch.from_numpy(np.random.default_rng(5).random((1, 4, 6, 6), dtype=np.float32) - 0.5)
    with torch.no_grad():
        ref = m(x).numpy()
    export_onnx(m, x, str(tmp_path / "op.onnx"), output_names=["y"])
    got, = cv2_forward(tmp_path / "op.onnx", x.numpy(), ["y"])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_an_aten_target_with_no_emitter_raises(tmp_path):
    class Cumsum(torch.nn.Module):
        def forward(self, x):
            return x.cumsum(1)

    with pytest.raises(NotImplementedError, match=r"ATen target 'aten\.cumsum\.default' has no emitter"):
        export_onnx(Cumsum(), torch.zeros(1, 3, 4, 4), str(tmp_path / "x.onnx"))
    assert not (tmp_path / "x.onnx").exists()


def test_autobackend_refusals(tmp_path, monkeypatch):
    """A `.ckpt` and an unknown suffix raise ValueError, as in the JAX AutoBackend; the ONNX runtime (cv2.dnn, a
    CPU runtime) raises ValueError when asked for the card, which is the default, rather than run on the CPU;
    without OpenCV it raises an ImportError naming it."""
    with pytest.raises(ValueError, match="carry only weights"):
        AutoBackend(tmp_path / "x.ckpt")
    with pytest.raises(ValueError, match="unsupported weights"):
        AutoBackend(tmp_path / "x.bin")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # past resolve_device's own refusal
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(ValueError, match="cv2.dnn, which runs on the CPU; pass device='cpu'"):
            AutoBackend(tmp_path / "x.onnx", device=device)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="ONNX runtime of AutoBackend"):
        AutoBackend(tmp_path / "x.onnx", device="cpu")
