"""The five YOLOv8 scales (n/s/m/l/x) of the port against the JAX package, on the CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree and reach the port through the weight bridge, so both packages run the
same numbers. Its conv biases are U(±0.5), not the published bias init
(whose cls bias, log(5 / 80 / (640 / s)^2), would put every score near 1e-5
and leave the NMS nothing), so the class scores sit near 0.5, the candidate
pools are full and suppression really happens. For yolov8n's entry points the
box towers' last bias falls by 1 a DFL bin in both packages' weights, so the
boxes are about a stride wide and fit the 64-pixel frames that `val` is
labelled with (with a near-uniform DFL they reach ~250 px).

* Each scale's graph: the YAML byte for byte, layer specs and save list, the
  parameter count of the JAX package (`tests/test_models.py`), the variable
  shapes, a strict load and the bridge's round trip, and the conv3x3 sites.
* The Detect head against the JAX head in eval mode, after the serving fold
  and in train mode (maps atol 1e-5, new BN statistics rtol/atol 1e-5, as
  `tests/test_torch_v10.py`).
* `non_max_suppression` (the greedy loop in `nms_plain`, as on any CPU
  tensor) against the JAX one on seeded pools of up to 8400 anchors,
  compared tie-tolerantly (`utils/compare.py`): the pool keeps `lax.top_k`'s
  order of tied scores, and the greedy steps take the first of equal scores in
  pool order, but f32 rounding may still order near-equal scores otherwise.
* yolov8n at full width, imgsz 64 (cheap): detections, `predict`,
  `val(data=...)` and `.ckpt` files both ways against the JAX package.
* One v8 train step on a narrow yolov8n (widths 8-64, nc 4, batch 2): loss and
  items against the JAX step, the first momentum trace against the port's f64
  run, at the tolerances of `tests/test_torch_v10.py`; then `train(data=...)`
  on the CPU, its results.csv against the JAX trainer's rows.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import cv2
import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn.heads import Detect as JaxDetect
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.ops.postprocess import non_max_suppression as jax_nms
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.nn.heads import Detect
from lpc_yolo_tpu_torch.ops.nms import nms_greedy, nms_plain, non_max_suppression
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables
from lpc_yolo_tpu_torch.utils.metrics import box_iou_np

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v8"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
PARAMS = {"n": 3_157_184, "s": 11_166_544, "m": 25_902_624, "l": 43_691_504, "x": 68_229_632}
S = 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
INVALID = [0.0, 0.0, 0.0, 0.0, 0.0, -1.0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_shapes(jm):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))


def small_boxes(variables, head: str = "model_22"):
    """The variables with every box tower's last bias falling by 1 a DFL bin (boxes of ~0.6 bins a side,
    which fit a 64 frame)."""
    params = jax.tree.map(np.array, variables["params"])
    for name, leaf in params[head].items():
        if name.startswith("cv2_") and name.endswith("_2"):
            leaf["bias"] = np.tile(-1.0 * np.arange(16, dtype=np.float32), 4)
    return {**variables, "params": params}


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


# -- the graphs ----------------------------------------------------------------------------------


def kernel_sites(tm) -> int:
    return sum(isinstance(m, TM.ConvBN) and m.kernel_path for m in tm.modules())


@pytest.mark.parametrize("scale", list(PARAMS))
def test_scale_graph_matches_jax(scale):
    """`YOLO("yolov8<scale>.yaml")` resolves to the port's copy of the JAX `v8/yolov8.yaml` at that scale: the
    same layer specs and save list as the JAX `parse_model`, the JAX package's parameter count, variable shapes
    equal to the JAX ones, bridged weights loaded with strict=True and back to the JAX tree bit for bit. The
    task is "v8"; strides 8/16/32; the conv3x3 kernel takes two convs per C2f bottleneck and the twelve 3x3
    convs of the Detect towers."""
    assert (PORT_CFG / "yolov8.yaml").read_bytes() == (JAX_CFG / "yolov8.yaml").read_bytes()
    yolo = YOLO(f"yolov8{scale}.yaml", device="cpu", seed=None)
    assert yolo.task == "v8" and yolo.model_yaml["scale"] == scale
    specs, save = TC.parse_model(yolo.model_yaml)
    jd = JC.yaml_model_load(JAX_CFG / "yolov8.yaml")
    jd["scale"] = scale
    jspecs, jsave = JC.parse_model(jd)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    tm = yolo.model
    assert sum(p.numel() for p in tm.parameters()) == PARAMS[scale]
    assert tm.strides == (8.0, 16.0, 32.0) and not tm.dead and tm.task == "v8"
    bottlenecks = sum(s.args[2] for s in specs if s.module == "C2f")
    assert kernel_sites(tm) == 2 * bottlenecks + 12
    shapes = jax_shapes(jax_build(jd))
    flat = lambda tree: {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in  # noqa: E731
                         jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}
    port_shapes = flax_shapes(tm)
    for col in ("params", "batch_stats"):
        assert flat(port_shapes[col]) == flat(shapes[col])
    variables = random_variables(shapes, seed=0)
    missing = tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    back = port_state_dict(tm.state_dict(), variables)
    for col in ("params", "batch_stats"):
        ref = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(ref) == len(got)
        for path, arr in ref:
            np.testing.assert_array_equal(np.asarray(got[path]), arr)


# -- the Detect head -----------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_detect_head_matches_jax(mode):
    """yolov8n's head (ch 64/128/256, nc 80; 80 cls channels, c3 = 80) on 8x8/4x4/2x2 maps: the per-level
    maps within atol 1e-5 of the JAX head's in eval mode, after `fuse_conv_bn` and in train mode; in train mode
    also the new BN running statistics (rtol/atol 1e-5), and in eval mode they stay. The bias init is the
    JAX one."""
    ch, strides = (64, 128, 256), (8.0, 16.0, 32.0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jhead = JaxDetect(nc=80, ch=ch, strides=strides)
    init = jhead.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs], training=True)
    variables = random_variables(jax.eval_shape(lambda: init), seed=0)
    head = Detect(nc=80, ch=ch, strides=strides)
    for i, s in enumerate(strides):  # the bias init, against the JAX initialiser's
        torch.testing.assert_close(head.cv3[i][2].bias, torch.from_numpy(np.array(init["params"][f"cv3_{i}_2"]["bias"])))
        assert torch.equal(head.cv2[i][2].bias, torch.ones(64))
    head.load_state_dict(flax_to_state_dict(variables), strict=True)
    if mode == "train":
        ref, mut = jhead.apply(variables, [jnp.asarray(x) for x in xs], training=True, mutable=["batch_stats"])
        got = head.train()([_nchw(x) for x in xs])
        stats = {k: b for k, b in head.named_buffers() if k.endswith(("running_mean", "running_var"))}
        new = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
        new = {k: v for k, v in new.items() if not k.endswith("num_batches_tracked")}
        assert stats.keys() == new.keys()
        for k, t in stats.items():
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        ref = jhead.apply(variables, [jnp.asarray(x) for x in xs], training=False)
        head.eval()
        if mode == "folded":
            fuse_conv_bn(head, torch.float32)
        with torch.no_grad():
            got = head([_nchw(x) for x in xs])
        before = flax_to_state_dict(variables)
        assert all(torch.equal(b, before[k]) for k, b in head.named_buffers() if "running" in k)
    assert len(got) == len(ref) == 3
    for (box, cls), r in zip(got, ref):
        assert box.shape[1] == 64 and cls.shape[1] == 80
        maps = torch.cat([box, cls], 1).detach().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(maps, np.asarray(r), atol=1e-5, rtol=0)


# -- non_max_suppression ---------------------------------------------------------------------------------


def make_preds(seed: int, B: int, A: int, nc: int, score_scale: float = 1.0) -> np.ndarray:
    """(B, A, 4 + nc) f32: xywh boxes over a 640 frame (8 to 160 px a side), uniform scores."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 640, (B, A, 2))
    wh = rng.uniform(8, 160, (B, A, 2))
    scores = rng.uniform(0, 1, (B, A, nc)) * score_scale
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


# (id, B, A, nc, score scale, kwargs)
NMS_CASES = [
    ("default", 2, 1000, 80, 1.0, {}),
    ("multi_label", 2, 8400, 80, 1.0, dict(conf_thres=0.001, iou_thres=0.7, multi_label=True)),
    ("agnostic", 2, 1000, 5, 1.0, dict(agnostic=True)),
    ("anchor_idx", 2, 8400, 80, 1.0, dict(return_anchor_idx=True)),
    ("fewer_than_max_det", 2, 50, 3, 1.0, dict(conf_thres=0.1)),
    ("nothing_passes", 2, 1000, 80, 0.2, {}),
]


@pytest.mark.parametrize("name,B,A,nc,scale,kw", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_nms_plain_matches_jax(name, B, A, nc, scale, kw):
    """The port's `non_max_suppression` on the CPU (the pre-pool in torch calls, the greedy loop in
    `nms_plain`) against the JAX function on the same pools: (B, 300, 6); as many valid rows per image; every
    valid row matched tie-tolerantly (box 1e-4, score 1e-6); invalid rows exactly [0, 0, 0, 0, 0, -1], after
    the valid ones. With return_anchor_idx: each valid row's anchor holds its box, and the anchors are JAX's
    wherever the rows are."""
    preds = make_preds(A + nc, B, A, nc, scale)
    ref = jax_nms(jnp.asarray(preds), **kw)
    launches = nms_greedy.launches
    got = non_max_suppression(torch.from_numpy(preds), **kw)
    assert nms_greedy.launches == launches  # a CPU tensor runs the plain version
    if kw.get("return_anchor_idx"):
        (ref, ref_anchor), (got, got_anchor) = ref, got
        ref_anchor, got_anchor = np.asarray(ref_anchor), got_anchor.numpy()
        assert got_anchor.dtype == np.int32
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (B, 300, 6) and got.dtype == np.float32
    for i in range(B):
        n = int((ref[i, :, 5] >= 0).sum())
        assert int((got[i, :, 5] >= 0).sum()) == n
        if name == "nothing_passes":
            assert n == 0
        elif name == "fewer_than_max_det":
            assert 0 < n <= A
        else:
            assert n > 10
        np.testing.assert_array_equal(got[i, n:], np.tile(INVALID, (300 - n, 1)))
        assert_detections_close(got[i, :n], ref[i, :n], atol_box=1e-4, atol_score=1e-6)
        if kw.get("return_anchor_idx"):
            boxes = preds[i, got_anchor[i, :n], :4]
            xyxy = np.concatenate([boxes[:, :2] - boxes[:, 2:] / 2, boxes[:, :2] + boxes[:, 2:] / 2], -1)
            np.testing.assert_allclose(got[i, :n, :4], xyxy, atol=1e-4)
            assert (got_anchor[i, n:] == 0).all()
            same = (got[i, :n] == ref[i, :n]).all(-1)
            assert same.mean() > 0.9 and (got_anchor[i, :n][same] == ref_anchor[i, :n][same]).all()


def test_nms_greedy_wrapper():
    """`nms_greedy` takes `nms_plain` for CPU tensors; the greedy steps take the first of equal scores
    (`jnp.argmax`), suppress within a label only (class offset) unless agnostic, keep a box at exactly the
    IoU threshold and drop one above it; it refuses what the kernel does not take."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 5.0],
                           [0.0, 0.0, 10.0, 6.0], [50.0, 50.0, 60.0, 60.0]]])
    scores = torch.tensor([[0.9, 0.9, 0.8, 0.7, 0.1]])
    labels = torch.tensor([[0, 0, 0, 1, 0]])
    anchors = torch.tensor([[7, 8, 9, 10, 11]])
    # box 2 has IoU 0.5 with box 0 (area 50 of 100), box 3 IoU 0.6 but label 1
    out, anc = nms_greedy(boxes, scores, labels, anchors, 0.25, 0.5, 6)
    torch.testing.assert_close(out[0, :3], torch.tensor([[0.0, 0.0, 10.0, 10.0, 0.9, 0.0], [0.0, 0.0, 10.0, 5.0, 0.8, 0.0],
                                                         [0.0, 0.0, 10.0, 6.0, 0.7, 1.0]]))
    assert anc[0].tolist() == [7, 9, 10, 0, 0, 0] and out[0, 3:].tolist() == [INVALID] * 3
    out, anc = nms_greedy(boxes, scores, labels, anchors, 0.25, 0.45, 6, agnostic=True)
    assert anc[0].tolist() == [7, 0, 0, 0, 0, 0]
    for bad in (dict(boxes=boxes[..., :3]), dict(scores=scores[:, :4]), dict(boxes=boxes.double())):
        args = {**dict(boxes=boxes, scores=scores, labels=labels, anchors=anchors), **bad}
        with pytest.raises(ValueError):
            nms_greedy(args["boxes"], args["scores"], args["labels"], args["anchors"], 0.25, 0.5, 6)
    ref = nms_plain(boxes, scores, labels, anchors, 0.25, 0.5, 6)
    got = nms_greedy(boxes, scores, labels, anchors, 0.25, 0.5, 6)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


# -- yolov8n through the entry points ------------------------------------------------------------------


@pytest.fixture(scope="module")
def v8n():
    """yolov8n at full width: the JAX model and its seeded variables, with small boxes."""
    jm = jax_build(JAX_CFG / "yolov8.yaml")
    return jm, small_boxes(random_variables(jax_shapes(jm), seed=0))


@pytest.fixture
def jax_facade(v8n, monkeypatch):
    """The JAX `YOLO` class with its `_jit_init` replaced by the shared variables (no init compile)."""
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: v8n[1])
    return jax_model.YOLO


def jax_detections(jm, variables, x, conf=0.25, iou=0.45, multi_label=False):
    pred = jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["pred"])(variables, x)
    return np.asarray(jax_nms(pred, conf, iou, 300, multi_label=multi_label))


@pytest.mark.parametrize("multi_label", [False, True])
def test_detections_match_jax(v8n, multi_label):
    """Full width, imgsz 64, batch 2, f32: `DetectionModel.predict` (decode_feats, then the NMS) against the
    JAX eval-mode `pred` through the JAX NMS, at the predictor's settings (conf 0.25, iou 0.45) and the
    validator's (conf 0.001, iou 0.7, multi_label), unfolded and after the serving fold (3x3 s1 convs through
    conv3x3's plain version); tie-tolerant, box 1e-3, score 1e-6, and as many rows kept."""
    jm, variables = v8n
    conf, iou = (0.001, 0.7) if multi_label else (0.25, 0.45)
    x = np.random.default_rng(3).random((2, S, S, 3), dtype=np.float32)
    ref = jax_detections(jm, variables, x, conf, iou, multi_label)
    tm = load_flax(build_model(PORT_CFG / "yolov8.yaml", device="cpu"), variables)
    with torch.no_grad():
        got = tm.predict(_nchw(x), conf=conf, iou=iou, multi_label=multi_label).numpy()
        folded = fuse_conv_bn(tm, torch.float32).predict(_nchw(x), conf=conf, iou=iou,
                                                          multi_label=multi_label).numpy()
    assert got.shape == ref.shape == (2, 300, 6) and np.isfinite(got).all()
    for i in range(2):
        n = int((ref[i, :, 5] >= 0).sum())
        assert n > 5 and int((got[i, :, 5] >= 0).sum()) == int((folded[i, :, 5] >= 0).sum()) == n
        assert_detections_close(got[i, :n], ref[i, :n], atol_box=1e-3, atol_score=1e-6)
        assert_detections_close(folded[i, :n], ref[i, :n], atol_box=1e-3, atol_score=1e-6)


def frames(seed=11):
    """Frames that need no resize at imgsz 64 (r = 1), so both letterboxes give byte-equal feeds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (48, 64, 3))]


def test_predict_matches_jax_pipeline(v8n, jax_facade):
    """YOLO("yolov8n.yaml").predict against the JAX facade's `YOLO.predict` on the same weights, imgsz 64, at
    the default conf 0.25 and iou 0.45 and at conf 0.5, iou 0.3: scores within 1e-6 (tie-tolerant), boxes
    within 1e-3, as many boxes kept."""
    im = frames()
    jy = jax_facade("yolov8n.yaml")
    assert jy.task == "v8"
    yolo = YOLO("yolov8n.yaml", device="cpu", seed=None).load_flax(v8n[1])
    for kw in ({}, dict(conf=0.5, iou=0.3)):
        ref = jy.predict(im, imgsz=S, batch=2, **kw)
        results = yolo.predict(im, device="cpu", imgsz=S, batch=2, **kw)
        assert len(results) == len(ref) == 2
        for r, j, f in zip(results, ref, im):
            assert r.orig_shape == f.shape[:2] and len(r) == len(j) > 0
            assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-6)


def test_yolo_save_loads_in_both_packages(v8n, jax_facade, tmp_path):
    """The port's `YOLO.save` of a yolov8n -> the JAX `YOLO(path)`: task "v8", the same variables bit for bit
    and detections within 1e-6; that model's `save` -> the port's `YOLO(path)`: task "v8", the same weights,
    the port's detections unchanged."""
    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    yolo = YOLO("yolov8n.yaml", device="cpu", seed=5, nc=3)
    yolo.names = {0: "red", 1: "green", 2: "blue"}
    jy = jax_facade(yolo.save(tmp_path / "port.ckpt"))
    assert (jy.model.nc, jy.task, jy.names) == (3, "v8", yolo.names)
    ref, got = jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got[col]),
                                    jax.tree_util.tree_leaves_with_path(ref[col])):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    im = frames(12)
    ours = yolo.predict(im, imgsz=S, batch=2, device="cpu")
    for r, j in zip(ours, jy.predict(im, imgsz=S, batch=2)):
        assert len(r) == len(j) > 0
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-6)
    back = YOLO(jy.save(str(tmp_path / "jax.ckpt")), device="cpu")
    assert (back.model.nc, back.task, back.names) == (3, "v8", yolo.names)
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for r, o in zip(back.predict(im, imgsz=S, batch=2, device="cpu"), ours):
        np.testing.assert_array_equal(r.boxes.data, o.boxes.data)


def write_dataset(root: Path, jm, variables) -> Path:
    """Six noise PNGs no larger than imgsz (the validator's scaleup=False only pads them, so both
    letterboxes give byte-equal feeds), one without a label file; the labels are the JAX model's own
    detections at the validator's settings, each its class's strongest, inside the frame and not
    overlapping another label."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i, (h0, w0) in enumerate(((48, 40), (64, 64), (50, 64), (32, 56), (64, 30), (40, 40))):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 4:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        assert gain == 1.0
        det = jax_detections(jm, variables, lb[None, ..., ::-1].astype(np.float32) / 255, 0.001, 0.7, True)[0]
        keep, seen = [], set()
        for row in det[det[:, 5] >= 0]:  # in the order of their scores
            b, c = row[:4].astype(np.float64), int(row[5])
            if c in seen:
                continue
            seen.add(c)
            if min(b[2] - b[0], b[3] - b[1]) < 4 or min(b[0] - pw, b[1] - ph, pw + w0 - b[2], ph + h0 - b[3]) < 0:
                continue  # too small, or not inside the frame
            if keep and box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, c))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = b - [pw, ph, pw, ph]
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 80}))
    return root / "data.yaml"


def test_val_matches_jax(v8n, jax_facade, tmp_path):
    """YOLO("yolov8n.yaml").val(data=...) (conf 0.001, iou 0.7, multi_label NMS) equals the JAX YOLO.val's
    results dict (`assert_val_results_agree`: mAP keys and fitness to the last digit)."""
    data = write_dataset(tmp_path, *v8n)
    ref = jax_facade("yolov8n.yaml").val(data=str(data), imgsz=S, batch=4, workers=2)
    got = YOLO("yolov8n.yaml", device="cpu", seed=None).load_flax(v8n[1]).val(
        data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.3  # the labels are the JAX model's own detections
    assert_val_results_agree(got, ref)


# -- training a narrow yolov8n ------------------------------------------------------------------------------


def narrow_yaml(nc: int = 4) -> dict:
    d = yaml.safe_load((PORT_CFG / "yolov8.yaml").read_text())
    d.update(nc=nc, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    return d


def make_batch(seed: int) -> dict:
    """A batch of f32 RGB frames in [0, 1] and padded gts."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (2, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (2, 4, 2))], -1).astype(np.float32)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    return {"img": rng.random((2, S, S, 3), dtype=np.float32), "cls": rng.integers(0, 4, (2, 4)).astype(np.int32),
            "bboxes": boxes * mask[..., None], "mask": mask}


def port_first_trace(tm, batch, dtype, cfg):
    """The port's v8 loss on `batch` and the clipped gradient (+ weight_decay * p on kernels) that one update
    from zero momentum leaves in the momentum trace."""
    tm = tm.to(dtype).train()
    dev = tts.to_device(batch, torch.device("cpu"))
    dev["img"] = dev["img"].to(dtype)
    total, items = tts.make_loss_fn(tm)(dev)
    total.backward()
    named = dict(tm.named_parameters())
    grads = [p.grad for p in named.values()]
    gnorm = tts.global_norm(grads)
    trace = {k: g * (cfg.grad_clip / gnorm.clamp(min=cfg.grad_clip)) + (cfg.weight_decay * p if p.dim() == 4 else 0)
             for (k, p), g in zip(named.items(), grads)}
    return total.detach(), items, trace


def assert_named_close(named, ref, tol, what, floor):
    assert named.keys() == ref.keys()
    for k, t in named.items():
        r = ref[k].detach().double().numpy()
        np.testing.assert_allclose(t.detach().double().numpy(), r, rtol=0, atol=tol * np.abs(r).max() + floor,
                                   err_msg=f"{what} {k}")


def test_train_step_matches_jax():
    """The v8 loss (top-10 assigner, 3 items) through the JAX step (loss_kind "v8") and the port's: loss and
    items rtol 1e-4; the first momentum trace of the JAX step within 1e-2 of each leaf's largest value of the
    port run in f64, the port's f32 trace within 2e-3 of it, and the two f32 traces within 1e-2 of each other
    (floor 1e-5): the tolerances of `tests/test_torch_v10.py`, whose docstring says why. Then the port's own
    step: 3 items, every leaf finite, the parameters moved on the second step."""
    d = narrow_yaml()
    jm = jax_build(d)
    variables = random_variables(jax_shapes(jm), seed=0)
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v8").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    assert np.asarray(jmet["items"]).shape == (3,)
    total, items, t32 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float32, tcfg)
    _, _, t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64, tcfg)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)
    assert_named_close(t32, ref, 1e-2, "trace of", floor=1e-5)

    tm = load_flax(build_model(d, device="cpu"), variables)
    state = tts.init_train_state(tm, tcfg, device="cpu")
    step = tts.make_train_step(tm, tcfg, loss_kind="v8")
    start = {k: v.detach().clone() for k, v in state.params.items()}
    for i in range(2):
        state, met = step(state, make_batch(i))
        assert met["items"].shape == (3,) and met["skipped"] is False
    assert all(torch.isfinite(v).all() for v in state.params.values())
    assert any(not torch.equal(v, start[k]) for k, v in state.params.items())
    with pytest.raises(ValueError, match="task .v8."):
        tts.make_train_step(tm, tcfg, loss_kind="v10")  # a Detect model has no one-to-one branch


@pytest.fixture(scope="module")
def narrow_world(tmp_path_factory):
    """The narrow YAML at nc 3 as a file, and a synthetic dataset of 8 + 2 frames."""
    tmp = tmp_path_factory.mktemp("v8train")
    path = tmp / "yolov8-narrow.yaml"
    path.write_text(yaml.safe_dump(narrow_yaml(3)))
    data = make_synthetic_dataset(tmp / "ds", n_train=8, n_val=2, imgsz=S, nc=3, max_boxes=3, seed=1)
    return {"path": path, "data": data}


def test_train_data_on_the_cpu(narrow_world, tmp_path):
    """`YOLO(<narrow v8 yaml>, nc=3).train(data=...)` on the CPU: 2 epochs of batch 4, every step finite and
    none skipped, the v8 items (box, cls, dfl) in `epoch_history` and results.csv, a validation each epoch
    through the NMS, last.ckpt and best.ckpt; the facade then holds the EMA weights and predicts."""
    yolo = YOLO(narrow_world["path"], device="cpu", seed=0, nc=3)
    res = yolo.train(data=narrow_world["data"], imgsz=S, batch=4, epochs=2, close_mosaic=1, workers=2,
                     device="cpu", save_dir=tmp_path / "run")
    tr = yolo.trainer
    assert len(tr.history) == 4 and all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
    assert all(len(h["items"]) == 3 for h in tr.history)
    assert set(res) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                        "fitness"} and all(np.isfinite(list(res.values())))
    assert [r["epoch"] for r in tr.epoch_history] == [0, 1] and all("dfl" in r for r in tr.epoch_history)
    header = (tmp_path / "run" / "results.csv").read_text().splitlines()[0].split(",")
    assert header[:4] == ["epoch", "train/box", "train/cls", "train/dfl"]
    assert sorted(p.name for p in (tmp_path / "run" / "weights").iterdir()) == ["best.ckpt", "last.ckpt"]
    assert all(torch.equal(yolo.model.state_dict()[k], v) for k, v in tr.state.ema_params.items())
    results = yolo.predict(frames(), imgsz=S, batch=2, conf=0.0, device="cpu")
    assert len(results) == 2 and all(np.isfinite(r.boxes.data).all() for r in results)


def test_results_csv_matches_jax(narrow_world, tmp_path, monkeypatch):
    """results.csv of a v8 model against the JAX trainer's own rows: both trainers run 2 epochs on the dataset
    with the same stub train step (the same 3 f32 loss items and lr a step) and the same stub validation; the
    port writes the JAX header (train/box, train/cls, train/dfl) with its render_frac last and the same
    epoch, loss, validation and lr cells."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    rng = np.random.default_rng(4)
    items = rng.uniform(0, 5, (4, 3)).astype(np.float32)
    lrs = rng.uniform(0, 0.002, 4)
    keys = ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"]
    results = [dict(zip(keys, rng.uniform(0, 1, len(keys)).tolist())) for _ in range(2)]

    def counting(make):
        n = iter(range(8))
        return lambda *a, **k: make(next(n))

    jax_step = counting(lambda i: {"items": items[i], "skipped": np.asarray(False), "lr": jnp.float32(lrs[i])})
    port_step = counting(lambda i: {"loss": torch.tensor(0.0), "items": torch.from_numpy(items[i]),
                                    "lr": float(lrs[i]), "skipped": False})
    jax_results, port_results = counting(lambda i: results[i]), counting(lambda i: results[i])
    kinds = []

    class StubValidator:
        def __init__(self, *a, **k):
            pass

        __call__ = staticmethod(jax_results)

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    monkeypatch.setattr(jax_trainer, "init_train_state",
                        lambda *a: (types.SimpleNamespace(ema_params={}, batch_stats={}), None))
    monkeypatch.setattr(jax_trainer, "make_train_step",
                        lambda *a, **k: kinds.append(k["loss_kind"]) or (lambda state, batch: (state, jax_step())))
    monkeypatch.setattr(jax_trainer, "data_parallel_mesh", lambda **k: None)
    monkeypatch.setattr(jax_trainer, "replicate", lambda state, mesh: state)
    monkeypatch.setattr(jax_trainer, "shard_batch", lambda batch, mesh: batch)
    monkeypatch.setattr(jax_trainer, "Validator", StubValidator)
    monkeypatch.setattr(jax_trainer, "save_checkpoint", lambda *a: None)
    monkeypatch.setattr(port_trainer, "make_train_step",
                        lambda *a, **k: kinds.append(k["loss_kind"]) or (lambda state, batch: (state, port_step())))
    monkeypatch.setattr(port_trainer.Trainer, "validate", lambda self, model, state: port_results())
    kw = dict(data=narrow_world["data"], epochs=2, batch=4, imgsz=S, workers=1, optimizer="adamw")
    jy = jax_model.YOLO(str(narrow_world["path"]), nc=3)
    jax_trainer.Trainer(jy, save_dir=str(tmp_path / "jax"), **kw).train()
    yolo = YOLO(narrow_world["path"], device="cpu", seed=0, nc=3)
    port_trainer.Trainer(yolo, save_dir=tmp_path / "port", device="cpu", **kw).train()
    assert kinds == ["v8", "v8"]

    ref, got = ((tmp_path / n / "results.csv").read_text().splitlines() for n in ("jax", "port"))
    header = ref[0].split(",")
    assert header[:4] == ["epoch", "train/box", "train/cls", "train/dfl"]
    assert got[0].split(",") == header + ["render_frac"] and len(got) == len(ref) == 3
    timing = {"time_s", "input_wait_frac", "render_frac"}
    for r, g in zip(ref[1:], got[1:]):
        rj, rp = dict(zip(header, r.split(","))), dict(zip(header + ["render_frac"], g.split(",")))
        assert {k: v for k, v in rp.items() if k not in timing} == {k: v for k, v in rj.items() if k not in timing}
