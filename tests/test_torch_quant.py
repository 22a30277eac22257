"""int8 post-training quantization of the port (`nn/quant.py`, `ops/conv_s8.py`, `ops/quantize_s8.py`,
`YOLO.quantize_int8`) against the JAX package's (`lpc_yolo_tpu/nn/quant.py`), on the CPU in f32, where both
kernels' wrappers run their plain versions. The JAX side runs under `quant.DEPLOY_INT8` as its own serving
graph sets it.

* The function faces: `q8_conv` at 1x1 / 3x3 and stride 1 / 2, and a conv too narrow to be a site;
  `q8_concat_conv` (with exact ties and clipping); `q8_pool_concat_conv`, whose pools the port runs before
  quantizing and the JAX package after. The s8 operands are bit-equal, the s32 sums equal, the outputs
  equal to one f32 ulp, and both packages call the same convs sites.
* yolov10n at 128 (the JAX test's own graph, `tests/test_quant.py`): the census of sites, and the
  calibrated scales within 1e-5 relative wherever both packages quantize the same tensor. The JAX deploy
  graph width-packs its narrow stages, and a packed conv passes the 64-channel rule on its packed width:
  those sites (`JAX_ONLY_V10N`) are the JAX package's alone.
* Whole graphs served int8, yolov10n at 128 and a narrow LPC-YOLO (width 0.25), against the JAX int8 graph
  (each package calibrated on the same frames) and against the port's f32 serving, at `tests/test_quant.py`'s
  tolerances (mean score 0.02, sorted scores 0.05, box mean 5%).
* The facade: `quantize_int8` then `predict`, `val` and `track`; a missing scale and a graph with no site raise.
  RT-DETR, World, the classifiers and YOLOv9: `tests/test_torch_quant_families.py`.

Weights come from `random_variables` over the port's shape tree and reach both packages.
"""

import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import modules as JMOD
from lpc_yolo_tpu.nn import quant as JQ
from lpc_yolo_tpu.nn.fuse import fold_preprocess as jax_fold_preprocess

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import predictor as TP
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import quant as TQ
from lpc_yolo_tpu_torch.nn.fuse import int8_sites, site_eligible
from lpc_yolo_tpu_torch.ops.quantize_s8 import quantize_s8
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, load_flax, random_variables

ROOT = Path(__file__).resolve().parents[1]
PORT_V10 = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10"
JAX_V10 = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v10"
S = 128  # the JAX test's size: v10n's >= 64-channel stages exist
CPU = torch.device("cpu")
# yolov10n at 128, batch 2: the JAX record pass's sites that quantize a width-packed conv whose logical width is
# under 64 (the port's plain graph serves them in f32), by their index in the JAX pass
JAX_ONLY_V10N = {
    0: "model.1 (3x3 s2, 16 -> 32)", 1: "model.2.cv1 (32 -> 32)", 2: "model.2.m.0.cv1 (16)", 3: "model.2.m.0.cv2 (16)",
    4: "model.2.cv2 (48 -> 32)", 5: "model.3 (3x3 s2, 32 -> 64)", 7: "model.4.m.0.cv1 (32)", 8: "model.4.m.0.cv2 (32)",
    9: "model.4.m.1.cv1 (32)", 10: "model.4.m.1.cv2 (32)", 37: "model.16.m.0.cv1 (32)", 38: "model.16.m.0.cv2 (32)",
}
V10N_CENSUS = {(1, 1): 33, (3, 1): 16, (3, 2): 1}  # (k, stride) of the port's 50 sites


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The graphs are small: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_int8(fn, *args, scale, **kw):
    """A JAX quant function under an int8 QuantCtx with one calibrated scale."""
    token = JQ.DEPLOY_INT8.set(JQ.QuantCtx(scales=(scale,)))
    try:
        return np.asarray(fn(*args, **kw))
    finally:
        JQ.DEPLOY_INT8.reset(token)


@pytest.fixture
def jax_convs(monkeypatch):
    """The operands and result of every JAX conv call: (lhs, rhs, out) as numpy."""
    seen = []
    orig = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *a, **k):
        out = orig(lhs, rhs, *a, **k)
        seen.append((np.asarray(lhs), np.asarray(rhs), np.asarray(out)))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    return seen


@pytest.fixture
def port_convs(monkeypatch):
    """The s8 operands of every port conv_s8 call: (x8, w8 HWIO) as numpy."""
    seen = []
    orig = TQ.conv_s8

    def spy(x8, w8, *a, **k):
        seen.append((x8.numpy(), w8.permute(1, 2, 3, 0).numpy()))
        return orig(x8, w8, *a, **k)

    monkeypatch.setattr(TQ, "conv_s8", spy)
    return seen


def exact_sums(x8: np.ndarray, w8: np.ndarray, stride: int) -> np.ndarray:
    """The s32 sums of an NHWC s8 x and an HWIO s8 w, same padding, through an f64 conv (exact)."""
    k = w8.shape[0]
    acc = F.conv2d(torch.from_numpy(x8).permute(0, 3, 1, 2).double(), torch.from_numpy(w8).permute(3, 2, 0, 1).double(),
                   stride=stride, padding=k // 2)
    return acc.permute(0, 2, 3, 1).numpy()


def assert_same_s8(port, jax_seen, stride=1):
    """Bit-equal s8 operands and equal s32 sums of the one s8 conv each package ran."""
    (x8, w8), = port
    jx8, jw8, jy32 = next(c for c in jax_seen if c[0].dtype == np.int8)
    np.testing.assert_array_equal(x8, jx8)
    np.testing.assert_array_equal(w8, jw8)
    assert jy32.dtype == np.int32
    np.testing.assert_array_equal(exact_sums(x8, w8, stride), jy32.astype(np.float64))


# (k, stride, Cin, Cout): the four geometries of the kernel, and a conv narrower than 64 channels (no site)
Q8_CONV_CASES = [(1, 1, 64, 96), (1, 2, 96, 64), (3, 1, 64, 64), (3, 2, 128, 64), (3, 1, 32, 64)]


@pytest.mark.parametrize("k,s,cin,cout", Q8_CONV_CASES, ids=["1x1s1", "1x1s2", "3x3s1", "3x3s2", "narrow"])
def test_q8_conv_matches_jax(k, s, cin, cout, jax_convs, port_convs):
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    pad = [(k // 2, k // 2)] * 2
    eligible = JQ._site_eligible(jnp.asarray(x), jnp.asarray(w), 1, (1, 1))
    assert site_eligible(nn.Conv2d(cin, cout, k, s, k // 2, bias=False)) == eligible == (cin >= 64)
    scale = float(np.abs(x).max())
    ref = jax_int8(JQ.q8_conv, jnp.asarray(x), jnp.asarray(w), (s, s), pad, scale=scale)
    got = TQ.q8_conv(torch.from_numpy(x), torch.from_numpy(w), (s, s), pad, scale if eligible else None).numpy()
    assert got.shape == ref.shape
    if eligible:
        assert_same_s8(port_convs, jax_convs, s)
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    else:
        assert not port_convs and all(c[0].dtype == np.float32 for c in jax_convs)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [127.0, 100.0], ids=["ties", "clipped"])
def test_q8_concat_conv_matches_jax(scale, jax_convs, port_convs):
    """Three parts of one tail: at scale 127 (sx 1) the half-integer inputs are exact ties (half to even); at
    100 the parts' values past 100 clip to 127."""
    rng = np.random.default_rng(3)
    parts = [(rng.integers(-250, 251, (2, 8, 8, 32)) / 2).astype(np.float32) for _ in range(3)]
    w = (rng.standard_normal((1, 1, 96, 64)) * 0.1).astype(np.float32)
    ref = jax_int8(JQ.q8_concat_conv, [jnp.asarray(p) for p in parts], jnp.asarray(w), scale=scale)
    got = TQ.q8_concat_conv([torch.from_numpy(p) for p in parts], torch.from_numpy(w), scale).numpy()
    assert_same_s8(port_convs, jax_convs)
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    x8 = port_convs[0][0]
    assert (np.abs(x8) == 127).any() if scale == 100.0 else np.array_equal(
        x8[..., :32], np.round(parts[0]).astype(np.int8))


def test_q8_pool_concat_conv_matches_jax(jax_convs, port_convs):
    """The SPPF tail: the port pools in f32 and quantizes each pool with x's scale, the JAX package pools in
    s8; the s8 concat is the same bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 256, 128)) * 0.1).astype(np.float32)
    scale = float(np.abs(x).max())
    ref = jax_int8(JQ.q8_pool_concat_conv, jnp.asarray(x), jnp.asarray(w), 5, scale=scale)
    got = TQ.q8_pool_concat_conv(torch.from_numpy(x), torch.from_numpy(w), 5, scale).numpy()
    assert_same_s8(port_convs, jax_convs)
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


# -- whole graphs ---------------------------------------------------------------------------------------------


def lpc_narrow(nc: int = 4, width: float = 0.25) -> dict:
    d = yaml.safe_load((PORT_V10 / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml").read_text())
    d.update(nc=nc, scales={"t": [0.1, width, 512]}, scale="t")
    return d


def port_frames(imgs: np.ndarray) -> torch.Tensor:
    """The JAX serving feed (B, S, S/8, 24) u8 BGR, width-packed, as the port's serving copy takes it: RGB, NCHW,
    0..255 in f32."""
    B, H = imgs.shape[:2]
    return torch.from_numpy(imgs.reshape(B, H, -1, 3)[..., ::-1].copy()).permute(0, 3, 1, 2).float()


def jax_serve(jm, variables, imgs):
    """The JAX Predictor's serving trace (`tests/test_quant.py::_serve`), jitted: (B, 300, 6)."""
    base = jm.clone(deploy=True)

    @jax.jit
    def predict(v, x_u8):
        v = jax_fold_preprocess(v, bgr=True)
        return base.apply(v, x_u8.astype(base.dtype), training=False, predict_only=True, input_layout="WPACK")["det"]

    return np.asarray(predict(variables, jnp.asarray(imgs)))


def forward_order(serving, x):
    """The port's site names in the order a serving forward runs them."""
    order = []
    hooks = [s.module.register_forward_pre_hook(lambda m, a, n=s.name: order.append(n)) for s in int8_sites(serving)]
    try:
        with torch.inference_mode():
            serving.predict(x)
    finally:
        for h in hooks:
            h.remove()
    return order


@pytest.fixture(scope="module", params=["yolov10n", "lpc_narrow"])
def graph(request):
    """Both packages' graph on the same weights and frames, each calibrated by its own package: the JAX scales
    (by record index), the JAX sites' kinds, the port's scales (by site name) and its unquantized serving copy."""
    cfg = str(PORT_V10 / "yolov10n.yaml") if request.param == "yolov10n" else lpc_narrow()
    jm = jax_build(str(JAX_V10 / "yolov10n.yaml") if request.param == "yolov10n" else cfg)
    tm = build_model(cfg, device=CPU)
    variables = random_variables(flax_shapes(tm), seed=0)
    load_flax(tm, variables)
    imgs = (np.random.RandomState(0).rand(2, S, S // 8, 24) * 255).astype(np.uint8)
    kinds = []

    def recorded(name, fn):
        def wrapper(*a, **k):
            ctx = JQ.DEPLOY_INT8.get()
            n0 = len(ctx.record) if ctx is not None and ctx.record is not None else None
            out = fn(*a, **k)
            if n0 is not None and len(ctx.record) > n0:
                kinds.append(name)
            return out
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name in ("q8_conv", "q8_concat_conv", "q8_pool_concat_conv"):
            mp.setattr(JMOD, name, recorded(name, getattr(JMOD, name)))
        jax_scales = JQ.calibrate_serving(jm, variables, [imgs])
    serving = serving_model(tm, CPU, torch.float32, int8=False)
    x = port_frames(imgs)
    return SimpleNamespace(name=request.param, jm=jm, tm=tm, variables=variables, imgs=imgs, x=x, serving=serving,
                           jax_scales=jax_scales, jax_kinds=kinds, scales=TQ.calibrate(serving, [x]))


def test_calibration_matches_jax(graph):
    """yolov10n: the port's census, and its scales against the JAX record pass's wherever both quantize the same
    tensor (every JAX site but `JAX_ONLY_V10N`, in forward order); the narrow LPC-YOLO: the census and the
    tails' kinds on both sides."""
    sites = int8_sites(graph.serving)
    census = Counter((s.conv.kernel_size[0], s.conv.stride[0]) for s in sites)
    assert list(graph.scales) == [s.name for s in sites]
    assert all(np.isfinite(v) and v > 0 for v in graph.scales.values())
    assert Counter(graph.jax_kinds)["q8_pool_concat_conv"] == 1  # SPPF's tail, one site in both packages
    assert sum(s.parts == 4 for s in sites) == 1
    if graph.name == "lpc_narrow":
        assert len(sites) == 24 and census == {(1, 1): 16, (3, 1): 8}
        return
    assert dict(census) == V10N_CENSUS and len(graph.jax_scales) == len(sites) + len(JAX_ONLY_V10N)
    shared = [v for i, v in enumerate(graph.jax_scales) if i not in JAX_ONLY_V10N]
    order = forward_order(graph.serving, graph.x)
    assert sorted(order) == sorted(graph.scales)
    for name, ref in zip(order, shared):
        assert abs(graph.scales[name] - ref) <= 1e-5 * ref, (name, graph.scales[name], ref)


def test_int8_serving_matches_jax(graph):
    """The int8 serving copy's detections against the JAX int8 graph's and against the port's f32 serving,
    at `tests/test_quant.py`'s tolerances."""
    qserving = TQ.quantize_serving(serving_model(graph.tm, CPU, torch.float32, int8=False), graph.scales)
    assert sum(getattr(m, "q8", None) is not None for m in qserving.modules()) == len(graph.scales)
    ref8 = jax_serve(graph.jm.clone(quant="int8", quant_scales=graph.jax_scales), graph.variables, graph.imgs)
    with torch.inference_mode():
        got = qserving.predict(graph.x).numpy()
        f32 = graph.serving.predict(graph.x).numpy()
    assert got.shape == ref8.shape == f32.shape and np.isfinite(got).all()
    for ref in (ref8, f32):
        s_ref, s_got = ref[..., 4], got[..., 4]
        assert abs(float(s_ref.mean()) - float(s_got.mean())) < 0.02
        assert float(np.abs(np.sort(s_ref, -1) - np.sort(s_got, -1)).max()) < 0.05
        b_ref, b_got = ref[..., :4], got[..., :4]
        assert abs(float(b_ref.mean()) - float(b_got.mean())) / (abs(float(b_ref.mean())) + 1e-9) < 0.05


# -- the facade ---------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def narrow_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8") / "lpc-narrow.yaml"
    path.write_text(yaml.safe_dump(lpc_narrow(nc=3)))
    return path


def test_facade_quantize_int8_predict_and_val(narrow_yaml, tmp_path, monkeypatch):
    """`quantize_int8` stores one scale a site on the model; `predict` and `val` then serve the int8 copy, whose
    detections agree with the f32 serving's as in `test_int8_serving_matches_jax`."""
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
    yolo = YOLO(narrow_yaml, device="cpu", seed=0)
    assert yolo.quantize_int8(frames, imgsz=S, batch=2) is yolo
    assert len(yolo.model.int8_scales) == 24
    served = []
    orig = TP.quantize_serving
    monkeypatch.setattr(TP, "quantize_serving", lambda m, sc: served.append(len(sc)) or orig(m, sc))
    got = yolo.predict(frames[:2], imgsz=S, batch=2, conf=0.0)
    data = make_synthetic_dataset(tmp_path / "data", n_train=1, n_val=4, imgsz=S, nc=3)
    metrics = yolo.val(data=data, imgsz=S, batch=2, workers=0)
    assert served == [24, 24] and all(np.isfinite(v) for v in metrics.values())
    scales = yolo.model.int8_scales
    del yolo.model.int8_scales
    ref = yolo.predict(frames[:2], imgsz=S, batch=2, conf=0.0)
    yolo.model.int8_scales = scales
    for r, q in zip(ref, got):
        s_ref, s_got = np.asarray(r.boxes.conf), np.asarray(q.boxes.conf)
        assert len(s_ref) == len(s_got) and abs(float(s_ref.mean()) - float(s_got.mean())) < 0.02
        assert float(np.abs(np.sort(s_ref) - np.sort(s_got)).max()) < 0.05


def test_track_serves_int8_and_train_keeps_the_scales(narrow_yaml, tmp_path, monkeypatch):
    """`track` goes through the int8 predict path; `train` ignores the scales (its step runs the unfolded model)
    and the model keeps them afterwards, as the JAX facade keeps its quant fields, so `predict` serves int8 again."""
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(2)]
    yolo = YOLO(narrow_yaml, device="cpu", seed=0)
    yolo.quantize_int8(frames, imgsz=64, batch=2)
    scales = dict(yolo.model.int8_scales)
    served = []
    orig = TP.quantize_serving
    monkeypatch.setattr(TP, "quantize_serving", lambda m, sc: served.append(len(sc)) or orig(m, sc))
    assert len(yolo.track(frames, imgsz=64)) == 2 and served == [24]
    mask = np.array([[True, True, False], [True, False, False]])
    batch = {"img": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8), "cls": np.zeros((2, 3), np.int32),
             "bboxes": np.tile(np.float32([8, 8, 40, 40]), (2, 3, 1)) * mask[..., None], "mask": mask}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorBoard sink: its import takes ~10 s
    yolo.train(batches=[batch], epochs=1, device="cpu", save_dir=tmp_path / "run")
    assert yolo.trainer.history and not any(h["skipped"] for h in yolo.trainer.history)
    assert yolo.model.int8_scales == scales
    yolo.predict(frames[0], imgsz=64)
    assert served == [24, 24]


def test_missing_scale_raises(narrow_yaml):
    yolo = YOLO(narrow_yaml, device="cpu", seed=0)
    yolo.quantize_int8(np.full((64, 64, 3), 90, np.uint8), imgsz=64, batch=1)
    scales = dict(yolo.model.int8_scales)
    scales.pop(next(iter(scales)))
    yolo.model.int8_scales = scales
    with pytest.raises(ValueError, match="calibrated scales"):
        yolo.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64)


def test_no_image_and_no_site_raise(narrow_yaml, tmp_path):
    with pytest.raises(ValueError, match="at least one image"):
        YOLO(narrow_yaml, device="cpu", seed=0).quantize_int8([], imgsz=64)
    d = yaml.safe_load((PORT_V10.parent / "v8" / "yolov8.yaml").read_text())
    d.update(nc=3, scales={"t": [0.33, 0.0625, 32]}, scale="t")  # no conv of 64 channels outside the Detect head
    tiny = tmp_path / "v8-tiny.yaml"
    tiny.write_text(yaml.safe_dump(d))
    with pytest.raises(ValueError, match="no quantizable conv sites"):
        YOLO(tiny, device="cpu", seed=0).quantize_int8(np.zeros((64, 64, 3), np.uint8), imgsz=64, batch=1)


def test_quantize_s8_rounds_half_to_even_and_clips():
    x = torch.tensor([-130.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5, 300.0]).reshape(1, 1, 10, 1)
    got = quantize_s8(x, 1.0).flatten().tolist()
    assert got == [-127, -2, -2, 0, 0, 2, 2, 126, 127, 127]
