"""int8 post-training quantization of RT-DETR, YOLO-World, the classifiers and YOLOv9 (`nn/quant.py`,
`nn/fuse.py::int8_sites`, `YOLO.quantize_int8`) against the JAX package's record pass and int8 graph
(`lpc_yolo_tpu/nn/quant.py`), on the CPU in f32, where both kernels' wrappers run their plain versions.

* Five graphs at their published widths at 128 px, batch 2: rtdetr-l (HGBlock's 7-part `sc`, RepC3; the small
  decoder of `tests/test_torch_rtdetr.py`), yolov8-cls-resnet50 (the 1x1 stride-2 shortcut), yolov8s-worldv2
  (C2fAttn, calibrated on zero text, the JAX record pass's), yolov8n-cls (the `Classify.conv` site) and yolov9c
  (RepNCSPELAN4's RepConvs). For each: the port's census, and its scales against the JAX record pass's within
  1e-5 relative in forward order, wherever both quantize the same tensor. A folded RepConv is one port site where
  the JAX package quantizes its 3x3 and 1x1 branches as two sites on the same input: both JAX scales equal the
  port's. The JAX deploy graph width-packs narrow stages, and a packed conv passes the 64-channel rule on its
  packed width: those sites (`JAX_ONLY`, by index) are the JAX package's alone.
* The int8 outputs against the JAX int8 graph's and the port's f32 serving's, at `tests/test_quant.py`'s
  tolerances (mean score 0.02, sorted scores 0.05, box mean 5%): the decoded boxes and each anchor's best score
  (yolov9c, World, whose zero text scores every class alike); RT-DETR's encoder scores before the top-k selection
  and the decoder's rows; the classifiers' probabilities, within 5% of the largest (and the same statistics).
* The facade: `quantize_int8` then `predict` and `val` of an RT-DETR graph, a classifier (its val:
  `engine/classify.py::evaluate_classifier`) and a World graph after `set_classes`, which keeps the scales; World
  calibrates on its class text.

Weights come from `random_variables` over the port's shape tree and reach both packages.
"""

from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn import modules as JMOD
from lpc_yolo_tpu.nn import quant as JQ
from lpc_yolo_tpu.nn.fuse import fold_preprocess as jax_fold_preprocess
from lpc_yolo_tpu.ops.letterbox import device_preprocess_wpack

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.data.synthetic import make_cls_dataset
from lpc_yolo_tpu_torch.engine import predictor as TP
from lpc_yolo_tpu_torch.engine.classify import evaluate_classifier
from lpc_yolo_tpu_torch.engine.predictor import serving_model
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import quant as TQ
from lpc_yolo_tpu_torch.nn.compiler import decode_feats, guess_model_scale, yaml_model_load
from lpc_yolo_tpu_torch.nn.fuse import int8_sites
from lpc_yolo_tpu_torch.nn.modules import C2fAttn, RepConv
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, load_flax, random_variables
from test_torch_quant import port_frames

ROOT = Path(__file__).resolve().parents[1]
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models"
S = 128  # every graph has >= 64-channel stages at 128, and the JAX-only lists below are the width-pack plans at 128, b2
CPU = torch.device("cpu")
SMALL_DECODER = [64, 60, 4, 4, 2, 256]  # hd, nq, ndp, nh, ndl, d_ffn (`tests/test_torch_rtdetr.py`); no site in a head
# name -> (the YAML under cfg/models, the port's census {(k, stride): sites}, quantize launches a forward, the
# folded RepConv sites, the JAX record pass's sites that quantize a width-packed conv of logical width under 64, by
# index)
GRAPHS = {
    "rtdetr-l": ("rt-detr/rtdetr-l.yaml", {(1, 1): 49, (3, 1): 18, (3, 2): 2}, 105, 12, {}),
    "yolov8-cls-resnet50": ("v8/yolov8-cls-resnet50.yaml", {(1, 1): 34, (3, 1): 13, (3, 2): 3, (1, 2): 3}, 53, 0, {}),
    "yolov8s-worldv2": ("v8/yolov8-worldv2.yaml", {(1, 1): 18, (3, 1): 22, (3, 2): 5}, 62, 0, {
        0: "model.1 (3x3 s2, 32 -> 64)", 2: "model.2.m.0.cv1 (32)", 3: "model.2.m.0.cv2 (32)"}),
    "yolov8n-cls": ("v8/yolov8-cls.yaml", {(1, 1): 7, (3, 1): 6, (3, 2): 2}, 20, 0, {
        0: "model.1 (3x3 s2, 16 -> 32)", 1: "model.2.cv1 (32)", 2: "model.2.m.0.cv1 (16)", 3: "model.2.m.0.cv2 (16)",
        4: "model.2.cv2 (48 -> 32)", 5: "model.3 (3x3 s2, 32 -> 64)", 7: "model.4.m.0.cv1 (32)",
        8: "model.4.m.0.cv2 (32)", 9: "model.4.m.1.cv1 (32)", 10: "model.4.m.1.cv2 (32)"}),
    "yolov9c": ("v9/yolov9c.yaml", {(1, 1): 67, (3, 1): 44, (3, 2): 6}, 117, 14, {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The graphs are small at 128: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def graph_dict(name: str) -> dict:
    d = yaml_model_load(PORT_CFG / GRAPHS[name][0])
    d["scale"] = guess_model_scale(f"{name}.yaml") or d["scale"]
    if d["head"][-1][2] == "RTDETRDecoder":
        d["head"][-1][3] = ["nc", *SMALL_DECODER]
    return d


def jax_serve(jm, variables, imgs):
    """The JAX serving trace of `calibrate_serving` (`lpc_yolo_tpu/nn/quant.py:252-293`), jitted: a Conv stem takes
    the /255 fold and the raw feed, another stem the normalised feed. Returns the outputs, and an RT-DETR graph's
    encoder scores (`enc_score_head`) before its top-k."""
    base = jm.clone(deploy=True)

    @jax.jit
    def run(v, x_u8):
        if base.specs[0].module == "Conv":
            v, x = jax_fold_preprocess(v, bgr=True), x_u8.astype(base.dtype)
        else:
            x = device_preprocess_wpack(x_u8, bgr=True)
        out, state = base.apply(v, x, training=False, predict_only=True, input_layout="WPACK",
                                capture_intermediates=lambda mdl, _: mdl.name == "enc_score_head")
        return out, jax.tree.leaves(state.get("intermediates", {}))

    out, enc = jax.tree.map(np.asarray, run(variables, jnp.asarray(imgs)))
    return out, enc[0] if enc else None


def port_outputs(model, x, text):
    """The port's counterparts of `jax_serve`'s: its outputs as the JAX graph names them, and the encoder scores."""
    enc = []
    head = model.model[-1]
    hook = head.enc_score_head.register_forward_hook(lambda m, a, y: enc.append(y)) \
        if model.task == "rtdetr" else None
    try:
        with torch.inference_mode():
            out = model(x, text=text) if model.task == "world" else model(x)
    finally:
        if hook is not None:
            hook.remove()
    if model.task in ("v8", "world"):
        nc = model.nc if text is None else text.shape[1]
        out = {"pred": decode_feats(out, model.strides, nc, model.reg_max)}
    return {k: v.numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}, enc[0].numpy() if enc else None


def assert_close_stats(got, ref, boxes=True):
    """`tests/test_quant.py`'s holds: mean score within 0.02, sorted scores within 0.05, box mean within 5%.
    `got` / `ref`: (..., 4 + nc) rows (each row's best score) or, with boxes False, (B, n) scores."""
    s_got, s_ref = (got[..., 4:].max(-1), ref[..., 4:].max(-1)) if boxes else (got, ref)
    assert abs(float(s_ref.mean()) - float(s_got.mean())) < 0.02
    assert float(np.abs(np.sort(s_ref, -1) - np.sort(s_got, -1)).max()) < 0.05
    if boxes:
        b_ref, b_got = ref[..., :4], got[..., :4]
        assert abs(float(b_ref.mean()) - float(b_got.mean())) / (abs(float(b_ref.mean())) + 1e-9) < 0.05


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    """Both packages' graph on the same weights and frames, each calibrated by its own package (a World graph on
    zero text, as the JAX record pass runs it): the JAX scales and each JAX site's kernel shape, by record index;
    the port's scales, its unquantized serving copy and its sites' forward order."""
    name = request.param
    d = graph_dict(name)
    tm = build_model(d, device=CPU)
    specs, save = JC.parse_model(d)
    jm = JC.DetectionModel(specs=specs, save=save, nc=d["nc"], strides=tuple(tm.strides))
    variables = random_variables(flax_shapes(tm), seed=0)
    load_flax(tm, variables)
    imgs = (np.random.RandomState(0).rand(2, S, S // 8, 24) * 255).astype(np.uint8)
    kernels = []

    def recorded(fn):
        def wrapper(x, W, *a, **k):
            ctx = JQ.DEPLOY_INT8.get()
            n0 = len(ctx.record) if ctx is not None and ctx.record is not None else None
            out = fn(x, W, *a, **k)
            if n0 is not None and len(ctx.record) > n0:
                kernels.append(tuple(W.shape[:2]))
            return out
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for fn in ("q8_conv", "q8_concat_conv", "q8_pool_concat_conv"):
            mp.setattr(JMOD, fn, recorded(getattr(JMOD, fn)))
        jax_scales = JQ.calibrate_serving(jm, variables, [imgs])
    serving = serving_model(tm, CPU, torch.float32, int8=False)
    x = port_frames(imgs)
    text = torch.zeros(1, d["nc"], 512) if serving.task == "world" else None
    order = []
    hooks = [s.module.register_forward_pre_hook(lambda m, a, n=s.name: order.append(n)) for s in int8_sites(serving)]
    try:
        scales = TQ.calibrate(serving, [x], text=text)
    finally:
        for h in hooks:
            h.remove()
    return SimpleNamespace(name=name, jm=jm, tm=tm, variables=variables, imgs=imgs, x=x, serving=serving,
                           text=None if text is None else text.expand(len(x), -1, -1), jax_scales=jax_scales,
                           jax_kernels=kernels, scales=scales, order=order)


def test_calibration_matches_jax(graph):
    """The port's census (sites by kernel and stride, quantize launches, folded RepConvs), and its scales against
    the JAX record pass's in forward order: each JAX site but `JAX_ONLY` is the port's next site, a RepConv's
    3x3 and 1x1 branches both the one site of its fold."""
    _, census, quantize, repconvs, jax_only = GRAPHS[graph.name]
    sites = int8_sites(graph.serving)
    assert dict(Counter((s.conv.kernel_size[0], s.conv.stride[0]) for s in sites)) == census
    assert sum(s.parts for s in sites) == quantize
    assert sum(isinstance(s.module, RepConv) for s in sites) == repconvs
    assert list(graph.scales) == [s.name for s in sites] and sorted(graph.order) == sorted(graph.scales)
    assert all(np.isfinite(v) and v > 0 for v in graph.scales.values())
    if graph.name == "rtdetr-l":  # each HGBlock's sc reads its input and its 6 convs' outputs
        assert sorted(s.parts for s in sites if s.name.endswith(".sc")) == [7] * 6
    if graph.name == "yolov8s-worldv2":  # each C2fAttn's cv2: cv1's output, a bottleneck's, the attention's
        attn = {id(m.cv2) for m in graph.serving.modules() if isinstance(m, C2fAttn)}
        assert sorted(s.parts for s in sites if id(s.module) in attn) == [3] * 4
    kinds = {s.name: isinstance(s.module, RepConv) for s in sites}
    shared = [j for j in range(len(graph.jax_scales)) if j not in jax_only]
    assert len(shared) == len(sites) + repconvs
    j = 0
    for name in graph.order:
        got = graph.scales[name]
        pair = shared[j:j + 2] if kinds[name] else shared[j:j + 1]
        if kinds[name]:
            assert [graph.jax_kernels[i] for i in pair] == [(3, 3), (1, 1)], name
        for i in pair:
            ref = graph.jax_scales[i]
            assert abs(got - ref) <= 1e-5 * ref, (name, i, got, ref)
        j += len(pair)
    assert j == len(shared)


def test_int8_serving_matches_jax(graph):
    """The int8 copy (q8 on exactly its sites) against the JAX int8 graph and against the port's f32 serving."""
    qserving = TQ.quantize_serving(serving_model(graph.tm, CPU, torch.float32, int8=False), graph.scales)
    assert {id(m) for m in qserving.modules() if getattr(m, "q8", None) is not None} == \
        {id(s.module) for s in int8_sites(qserving)}
    jm8 = graph.jm.clone(quant="int8", quant_scales=graph.jax_scales)
    ref8, enc8 = jax_serve(jm8, graph.variables, graph.imgs)
    got, enc = port_outputs(qserving, graph.x, graph.text)
    f32, enc32 = port_outputs(graph.serving, graph.x, graph.text)
    for ref, ref_enc in ((ref8, enc8), (f32, enc32)):
        if "probs" in ref:
            p_got, p_ref = got["probs"], ref["probs"]
            assert p_got.shape == p_ref.shape and np.isfinite(p_got).all()
            np.testing.assert_allclose(p_got.sum(-1), 1.0, rtol=1e-5)
            assert np.abs(p_got - p_ref).max() < 0.05 * p_ref.max()  # nc 1000: 0.0019 (n) to 0.02 (resnet50) at most
            assert_close_stats(p_got, p_ref, boxes=False)
            continue
        assert got["pred"].shape == ref["pred"].shape and np.isfinite(got["pred"]).all()
        assert_close_stats(got["pred"], ref["pred"])
        if ref_enc is not None:  # RT-DETR: each anchor's best encoder score, before the top-k
            sig = lambda t: 1 / (1 + np.exp(-t.max(-1)))
            assert enc.shape == ref_enc.shape
            assert_close_stats(sig(enc), sig(ref_enc), boxes=False)


# -- the facade --------------------------------------------------------------------------------------------------


def frames(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture
def served(monkeypatch):
    """The site counts of every int8 serving copy built (`serving_model` -> `quantize_serving`)."""
    counts, orig = [], TP.quantize_serving
    monkeypatch.setattr(TP, "quantize_serving", lambda m, sc: counts.append(len(sc)) or orig(m, sc))
    return counts


def unquantized(yolo, fn):
    """`fn()` with the model's scales set aside: the bf16 / f32 serving it is held to."""
    scales = yolo.model.int8_scales
    del yolo.model.int8_scales
    try:
        return fn()
    finally:
        yolo.model.int8_scales = scales


def test_facade_rtdetr_quantize_predict_and_val(tmp_path, served):
    """yolov8n-rtdetr (the small decoder, nc 3): `quantize_int8`, then `predict` and `val` serve the int8 copy,
    whose rows (no NMS: every query) agree with the f32 serving's."""
    d = yaml.safe_load((PORT_CFG / "v8" / "yolov8-rtdetr.yaml").read_text())
    d["head"][-1][3] = ["nc", *SMALL_DECODER]
    cfg = tmp_path / "yolov8n-rtdetr-small.yaml"
    cfg.write_text(yaml.safe_dump({**d, "nc": 3}))
    yolo = YOLO(cfg, device="cpu", seed=0)
    yolo.quantize_int8(frames(1), imgsz=64, batch=2)
    n = len(int8_sites(serving_model(yolo.model, CPU, torch.float32, int8=False)))
    assert n == len(yolo.model.int8_scales) == 32
    got = yolo.predict(frames(2), imgsz=64, batch=2, conf=0.0)
    ref = unquantized(yolo, lambda: yolo.predict(frames(2), imgsz=64, batch=2, conf=0.0))
    data = make_synthetic_dataset(tmp_path / "data", n_train=1, n_val=4, imgsz=64, nc=3)
    metrics = yolo.val(data=data, imgsz=64, batch=2, workers=0)
    assert served == [n, n] and all(np.isfinite(v) for v in metrics.values())
    for r, q in zip(ref, got):
        rows = lambda res: np.concatenate([res.boxes.xyxy / 64, res.boxes.conf[:, None]], 1)[None]
        assert len(r.boxes) == len(q.boxes) == 60
        assert_close_stats(rows(q), rows(r))


def test_facade_classifier_quantize_predict_and_val(tmp_path, served):
    """yolov8n-cls (nc 2) calibrated at the size it serves: `predict`'s probabilities and
    `evaluate_classifier`'s top-1 / top-5 come from the int8 copy; the probabilities within 0.02 of f32's."""
    yolo = YOLO("yolov8n-cls.yaml", device="cpu", seed=0, nc=2)
    yolo.quantize_int8(frames(3), imgsz=64, batch=2)
    assert len(yolo.model.int8_scales) == 15
    got = yolo.predict(frames(4), imgsz=64, batch=2)
    ref = unquantized(yolo, lambda: yolo.predict(frames(4), imgsz=64, batch=2))
    root = Path(make_cls_dataset(tmp_path / "cls", n_train=1, n_val=2, nc=2))
    metrics = evaluate_classifier(yolo.model, root / "val", imgsz=64, batch=2, workers=0, device="cpu")
    assert served == [15, 15] and set(metrics) == {"metrics/accuracy_top1", "metrics/accuracy_top5", "fitness"}
    for r, q in zip(ref, got):
        assert np.abs(np.asarray(q.probs.data) - np.asarray(r.probs.data)).max() < 0.02


def test_facade_world_quantize_set_classes_predict_and_val(tmp_path, served):
    """yolov8s-worldv2: `quantize_int8`, then `set_classes` keeps the scales (as the JAX facade keeps its quant
    fields); `predict` and `val` serve the int8 copy over the new classes, through the NMS, and its rows' scores
    agree with the f32 serving's on the class text."""
    yolo = YOLO("yolov8s-worldv2.yaml", device="cpu", seed=0)
    yolo.quantize_int8(frames(5), imgsz=64, batch=2)
    scales = dict(yolo.model.int8_scales)
    assert len(scales) == 45
    yolo.set_classes(["red", "green", "blue"])
    assert yolo.model.int8_scales == scales
    got = yolo.predict(frames(6), imgsz=64, batch=2, conf=0.0)
    ref = unquantized(yolo, lambda: yolo.predict(frames(6), imgsz=64, batch=2, conf=0.0))
    assert all(set(np.asarray(r.boxes.cls).tolist()) <= {0.0, 1.0, 2.0} for r in got)
    for r, q in zip(ref, got):
        s_ref, s_got = np.asarray(r.boxes.conf), np.asarray(q.boxes.conf)
        assert len(s_ref) == len(s_got) and abs(float(s_ref.mean()) - float(s_got.mean())) < 0.02
        assert float(np.abs(np.sort(s_ref) - np.sort(s_got)).max()) < 0.05
    data = make_synthetic_dataset(tmp_path / "data", n_train=1, n_val=4, imgsz=64, nc=3)
    metrics = yolo.val(data=data, imgsz=64, batch=2, workers=0)
    assert served == [45, 45] and all(np.isfinite(v) for v in metrics.values())


def test_world_calibrates_on_its_class_text(monkeypatch):
    """The facade calibrates a World graph on `txt_feats`, the table its predict and val serve (the JAX facade
    calibrates on zero text: ROADMAP Queue 3). Each C2fAttn tail's scale is the largest of its parts' absmax, so
    it moves with the text where the attention's output holds that largest value, as it does at three of the four."""
    seen = []
    orig = TQ.calibrate
    monkeypatch.setattr(TQ, "calibrate", lambda s, b, text=None: seen.append((s, b, text)) or orig(s, b, text=text))
    yolo = YOLO("yolov8s-worldv2.yaml", device="cpu", seed=0).set_classes(["person", "car"])
    yolo.quantize_int8(frames(7), imgsz=64, batch=2)
    (serving, batches, text), = seen
    np.testing.assert_array_equal(text.numpy(), yolo.txt_feats)
    zero = orig(serving, batches)
    attn = [s.name for s in int8_sites(serving) if any(s.module is m.cv2 for m in serving.modules()
                                                       if isinstance(m, C2fAttn))]
    assert len(attn) == 4 and sum(zero[n] != yolo.model.int8_scales[n] for n in attn) == 3
