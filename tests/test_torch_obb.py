"""The five YOLOv8 oriented-box scales (n/s/m/l/x-obb) of the port against the JAX package, on the CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree and reach the port through the weight bridge, as in `tests/test_torch_v8.py`
(whose docstring says why the box towers' last bias falls by 1 a DFL bin for
the entry points at imgsz 64).

* Each scale's graph at nc 15 (DOTAv1's classes): the YAML byte for byte,
  task "obb", specs and save list, the JAX parameter count (yolov8n-obb
  3,085,424 to yolov8x-obb 69,493,040), the variable shapes, a strict load
  and the bridge's round trip, the conv3x3 sites (the v8 ones and the 6 of the
  angle towers, c4 = 16 / 32 / 48 / 64 / 80).
* The OBB head's (feats, angle) in eval mode, after the serving fold and in
  train mode (with the new BN statistics); the whole graph's train and eval
  outputs on `tests/assets/tiny-obb.yaml` and on full-width yolov8n-obb;
  `decode_feats_obb` within 1e-5 of the largest value.
* `probiou` and `nms_rotated` against the JAX functions on seeded pools, with
  `multi_label` and `agnostic` both ways and fewer candidates than
  `max_det`, and the three cases of `tests/test_rotated_nms.py`.
* The rotated assigner (exact on untied metrics) and `v8_obb_loss` (JAX f32
  for the loss, the port's f64 run for the gradients).
* yolov8n-obb at full width, imgsz 64: `predict` on square frames, `.ckpt`
  files both ways, `val(data=...)` on a square DOTA-quad set (mAP keys equal to
  the last digit), the `max_gt` fault of the JAX validator, and
  `train(data=...)` on the JAX test's rotated set (`tests/test_tasks.py:251-275`)
  with the first step's loss items held to the JAX trainer's.
"""

import dataclasses
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.losses import task_aligned_assigner as jax_assigner
from lpc_yolo_tpu.losses.obb import v8_obb_loss as jax_obb_loss
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn.heads import OBB as JaxOBB
from lpc_yolo_tpu.nn.heads import decode_feats_obb as jax_decode_feats_obb
from lpc_yolo_tpu.ops.boxes import probiou as jax_probiou
from lpc_yolo_tpu.ops.boxes import rbox_hull as jax_rbox_hull
from lpc_yolo_tpu.ops.boxes import xywhr2xyxyxyxy as jax_corners
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.ops.postprocess import nms_rotated as _jax_nms_rotated
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.losses import task_aligned_assigner, v8_obb_loss
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.nn.heads import OBB, decode_feats_obb
from lpc_yolo_tpu_torch.ops.boxes import probiou, rbox_hull, xywhr2xyxyxyxy
from lpc_yolo_tpu_torch.ops.nms import nms_rotated
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v8"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
TINY = ROOT / "tests" / "assets" / "tiny-obb.yaml"
PARAMS = {"n": 3_085_424, "s": 11_427_568, "m": 26_425_584, "l": 44_490_224, "x": 69_493_040}
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the JAX function jitted once a shape and option set (op by op it compiles every op of every new shape)
jax_nms_rotated = jax.jit(_jax_nms_rotated, static_argnums=(2, 3, 4, 5, 6, 7))


def jax_shapes(jm, size=S):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), training=True))


def flat_shapes(tree):
    return {jax.tree_util.keystr(p): tuple(getattr(s, "shape", s)) for p, s in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda t: isinstance(t, tuple))}


def small_boxes(variables, head: str = "model_22"):
    """Every box tower's last bias falling by 1 a DFL bin (boxes that fit a 64 frame)."""
    params = jax.tree.map(np.array, variables["params"])
    for name, leaf in params[head].items():
        if name.startswith("cv2_") and name.endswith("_2"):
            leaf["bias"] = np.tile(-1.0 * np.arange(16, dtype=np.float32), 4)
    return {**variables, "params": params}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _maps(feats):
    """The port's per-level (box, cls) pairs as the JAX head's NHWC maps."""
    return [torch.cat([b, c], 1).detach().permute(0, 2, 3, 1).numpy() for b, c in feats]


def rand_rboxes(rng, shape, lo=8.0, hi=88.0, span=600.0):
    rb = np.zeros(shape + (5,), np.float32)
    rb[..., :2] = rng.random(shape + (2,)) * span + 20
    rb[..., 2:4] = rng.random(shape + (2,)) * (hi - lo) + lo
    rb[..., 4] = (rng.random(shape) - 0.25) * np.pi
    return rb


# -- the graphs ----------------------------------------------------------------------------------


@pytest.mark.parametrize("scale", list("nsmlx"))
def test_obb_scale_graph_matches_jax(scale):
    """`YOLO("yolov8<scale>-obb.yaml", nc=15)` resolves to the port's copy of the JAX `v8/yolov8-obb.yaml`: task
    "obb"; the JAX `parse_model`'s specs (ne 1) and save list; the JAX parameter count and variable shapes;
    bridged weights loaded strictly and back to the JAX tree bit for bit (the cv4 angle towers included); conv3x3
    takes the v8 sites plus two a level of the angle towers, whose width is c4 = max(ch[0] // 4, 1)."""
    assert (PORT_CFG / "yolov8-obb.yaml").read_bytes() == (JAX_CFG / "yolov8-obb.yaml").read_bytes()
    yolo = YOLO(f"yolov8{scale}-obb.yaml", device="cpu", seed=None, nc=15)
    assert yolo.task == "obb" and yolo.model_yaml["scale"] == scale
    specs, save = TC.parse_model({**yolo.model_yaml, "nc": 15})
    jd = JC.yaml_model_load(JAX_CFG / "yolov8-obb.yaml")
    jd.update(scale=scale, nc=15)
    jspecs, jsave = JC.parse_model(jd)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    assert specs[-1].module == "OBB" and tuple(specs[-1].args[:2]) == (15, 1)
    tm = yolo.model
    shapes = jax_shapes(jax_build(jd))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == PARAMS[scale]
    assert tm.strides == (8.0, 16.0, 32.0) and tm.model[-1].ne == 1 and tm.nc == 15
    c4 = tm.model[-1].cv4[0][0].conv.out_channels
    assert c4 == {"n": 16, "s": 32, "m": 48, "l": 64, "x": 80}[scale]
    bottlenecks = sum(s.args[2] for s in specs if s.module == "C2f")
    assert sum(isinstance(m, TM.ConvBN) and m.kernel_path for m in tm.modules()) == 2 * bottlenecks + 12 + 6
    for col in ("params", "batch_stats"):
        assert flat_shapes(flax_shapes(tm)[col]) == flat_shapes(shapes[col])
    variables = random_variables(shapes, seed=0)
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    back = port_state_dict(tm.state_dict(), variables)
    for col in ("params", "batch_stats"):
        ref = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(ref) == len(got)
        for path, arr in ref:
            np.testing.assert_array_equal(np.asarray(got[path]), arr)


# -- the OBB head, the graph and the rotated decode ----------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_obb_head_matches_jax(mode):
    """yolov8n-obb's head (ch 64/128/256, nc 15) on 8x8/4x4/2x2 maps: the Detect pairs within atol 1e-5 and the
    angle (B, A, 1) f32 within atol 1e-6 of the JAX head's (feats, angle) in eval mode, after `fuse_conv_bn` and in
    train mode; in train mode also the new BN statistics (rtol/atol 1e-5). Every angle lies in [-pi/4, 3 pi/4]."""
    ch, strides = (64, 128, 256), (8.0, 16.0, 32.0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jhead = JaxOBB(nc=15, ne=1, ch=ch, strides=strides)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs], training=True))
    variables = random_variables(shapes, seed=0)
    head = OBB(nc=15, ne=1, ch=ch, strides=strides)
    head.load_state_dict(flax_to_state_dict(variables), strict=True)
    if mode == "train":
        ref, mut = jhead.apply(variables, [jnp.asarray(x) for x in xs], training=True, mutable=["batch_stats"])
        got = head.train()([_nchw(x) for x in xs])
        stats = {k: b for k, b in head.named_buffers() if k.endswith(("running_mean", "running_var"))}
        new = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
        new = {k: v for k, v in new.items() if not k.endswith("num_batches_tracked")}
        assert stats.keys() == new.keys() and any(k.startswith("cv4.") for k in stats)
        for k, t in stats.items():
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        ref = jhead.apply(variables, [jnp.asarray(x) for x in xs], training=False)
        head.eval()
        if mode == "folded":
            fuse_conv_bn(head, torch.float32)
        with torch.no_grad():
            got = head([_nchw(x) for x in xs])
    (feats, angle), (rfeats, rangle) = got, ref
    for m, r in zip(_maps(feats), rfeats):
        np.testing.assert_allclose(m, np.asarray(r), atol=1e-5, rtol=0)
    assert angle.shape == (2, 84, 1) and angle.dtype == torch.float32
    np.testing.assert_allclose(angle.detach().numpy(), np.asarray(rangle), atol=1e-6, rtol=0)
    a = angle.detach().numpy()
    assert a.min() >= -np.pi / 4 and a.max() <= 3 * np.pi / 4


@pytest.mark.parametrize("graph", ["tiny-obb", "yolov8n-obb"])
def test_obb_graph_matches_jax(graph):
    """The whole graph, at a narrow width (`tests/assets/tiny-obb.yaml`, nc 3) and at full width (yolov8n-obb, nc 15),
    on a 64 input: train mode {"feats", "angle"} and eval mode {"feats", "angle", "pred"} of the JAX graph, every
    map and the decoded pred within 1e-5 of its largest value in eval mode, 1e-4 in train mode (the BatchNorm of a
    batch of 2 over maps down to 2x2 carries the summation order of its statistics), the angles within the same share of their range
    pi."""
    if graph == "tiny-obb":
        d = yaml.safe_load(TINY.read_text())
    else:
        d = JC.yaml_model_load(JAX_CFG / "yolov8-obb.yaml")
        d.update(scale="n", nc=15)
    jm = jax_build(d)
    variables = random_variables(jax_shapes(jm), seed=3)
    tm = load_flax(build_model(d, device="cpu"), variables)
    x = np.random.default_rng(4).random((2, S, S, 3), dtype=np.float32)
    for training in (False, True):  # eval first: the port's train-mode forward updates the BN statistics
        tol = 1e-4 if training else 1e-5
        if training:
            ref, _ = jax.jit(lambda v, t: jm.apply(v, t, training=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(x))
            got = tm.train()(_nchw(x))
            assert set(got) == {"feats", "angle"}
        else:
            ref = jax.jit(lambda v, t: jm.apply(v, t, training=False))(variables, jnp.asarray(x))
            with torch.no_grad():
                got = tm.eval()(_nchw(x))
            A = sum(b.shape[2] * b.shape[3] for b, _ in got["feats"])
            assert set(got) == {"feats", "angle", "pred"} and got["pred"].shape == (2, A, 4 + tm.nc + 1)
            r = np.asarray(ref["pred"])
            np.testing.assert_allclose(got["pred"].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
        for m, r in zip(_maps(got["feats"]), ref["feats"]):
            r = np.asarray(r)
            np.testing.assert_allclose(m, r, rtol=0, atol=tol * np.abs(r).max())
        np.testing.assert_allclose(got["angle"].detach().numpy(), np.asarray(ref["angle"]), rtol=0, atol=tol * np.pi)


def test_decode_feats_obb_matches_jax():
    """[cx, cy, w, h] rotated about each anchor by its angle, times the stride, the class sigmoids and the angle
    over three levels of a 96 input: within 1e-5 of the largest value of the JAX decode's."""
    rng = np.random.default_rng(2)
    shapes = [(12, 12), (6, 6), (3, 3)]
    A = sum(h * w for h, w in shapes)
    maps = [rng.standard_normal((2, h, w, 64 + 15)).astype(np.float32) * 2 for h, w in shapes]
    angle = ((rng.random((2, A, 1)) - 0.25) * np.pi).astype(np.float32)
    ref = np.asarray(jax_decode_feats_obb([jnp.asarray(m) for m in maps], jnp.asarray(angle), (8.0, 16.0, 32.0), 15))
    feats = [(_nchw(m[..., :64]), _nchw(m[..., 64:])) for m in maps]
    got = decode_feats_obb(feats, torch.from_numpy(angle), (8.0, 16.0, 32.0), 15).numpy()
    assert got.shape == ref.shape == (2, A, 4 + 15 + 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# -- probIoU and the rotated fast-NMS ------------------------------------------------------------------------


def test_probiou_corners_and_hull_match_jax():
    """`probiou` (broadcast (64, 1) x (1, 64), with boxes down to 1e-3 px wide, whose det clip and sqrt are near 0,
    and centres 14 x 7680 px away), `xywhr2xyxyxyxy` and `rbox_hull` within 1e-6 (probIoU) and 1e-5 of the
    largest value (corners, hulls) of the JAX functions'."""
    rng = np.random.default_rng(5)
    a, b = rand_rboxes(rng, (64,)), rand_rboxes(rng, (64,))
    b[:16] = a[:16] + rng.normal(0, 2, (16, 5)).astype(np.float32)
    a[16:24, 3] = 1e-3
    b[24:32, :2] += 14 * 7680
    ref = np.asarray(jax_probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
    got = probiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None]).numpy()
    assert got.shape == (64, 64) and (got >= 0).all() and (got <= 1).all() and got.max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for fj, ft in ((jax_corners, xywhr2xyxyxyxy), (jax_rbox_hull, rbox_hull)):
        r = np.asarray(fj(jnp.asarray(a)))
        np.testing.assert_allclose(ft(torch.from_numpy(a)).numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


def rows_match(got: np.ndarray, ref: np.ndarray, atol: float = 1e-5):
    """(N, 7) rotated rows of one image: as many kept, and tie-tolerant equal as (hull, score, label) rows, with
    the rotated parameters of each matched pair within atol of the largest coordinate."""
    kg, kr = got[got[:, 5] > 0], ref[ref[:, 5] > 0]
    assert len(kg) == len(kr)
    hull = lambda r: np.concatenate([np.asarray(jax_rbox_hull(jnp.asarray(r[:, :5]))), r[:, 5:7]], -1)
    assert_detections_close(hull(kg), hull(kr), atol_box=atol * max(1.0, np.abs(kr[:, :4]).max()), atol_score=1e-5)
    for row in kg:
        d = np.abs(kr[:, :5] - row[:5]).max(1)
        assert d.min() <= atol * max(1.0, np.abs(kr[:, :4]).max())


@pytest.mark.parametrize("multi_label", [False, True], ids=["best", "multi_label"])
@pytest.mark.parametrize("agnostic", [False, True], ids=["offset", "agnostic"])
@pytest.mark.parametrize("pool", ["full", "short"])
def test_nms_rotated_matches_jax(multi_label, agnostic, pool):
    """`nms_rotated` against the JAX function on a seeded b3 pool of 600 anchors (clusters of near-duplicates, 4
    classes): the (B, max_det, 7) rows, scores within 1e-5 and boxes within 1e-5 of the largest coordinate, the
    kept sets tie-tolerant (`utils/compare.py`); "short" has fewer candidates (20 anchors, 80 (anchor, class)
    pairs) than max_det (100), so the output is padded with 0 rows of label -1."""
    rng = np.random.default_rng(7)
    B, A, nc = 3, 600 if pool == "full" else 20, 4
    rb = rand_rboxes(rng, (B, A), span=300.0)
    rb[:, 1::3] = rb[:, ::3][:, : rb[:, 1::3].shape[1]] + rng.normal(0, 3, rb[:, 1::3].shape).astype(np.float32)
    scores = rng.random((B, A, nc)).astype(np.float32)
    args = (0.25, 0.45, 100, 256, agnostic, multi_label)
    ref = np.asarray(jax_nms_rotated(jnp.asarray(rb), jnp.asarray(scores), *args))
    got = nms_rotated(torch.from_numpy(rb), torch.from_numpy(scores), *args).numpy()
    assert got.shape == ref.shape == (B, 100, 7)
    for g, r in zip(got, ref):
        rows_match(g, r)
        assert (g[g[:, 5] == 0, 6] == -1).all() and not g[g[:, 5] == 0, :6].any()
    assert (got[..., 5] > 0).sum() > 20
    if pool == "short":
        assert (got[:, A * (nc if multi_label else 1):, 6] == -1).all()


def test_rotated_nms_static_shape_and_order():
    """`tests/test_rotated_nms.py`'s first case on the port: (64, 7) rows sorted by score, suppressed rows 0 with
    label -1, the same rows as the JAX function's."""
    rng = np.random.RandomState(0)
    rb = np.zeros((200, 5), np.float32)
    rb[:, 0], rb[:, 1] = rng.rand(200) * 600 + 20, rng.rand(200) * 600 + 20
    rb[:, 2], rb[:, 3] = rng.rand(200) * 80 + 8, rng.rand(200) * 80 + 8
    rb[:, 4] = (rng.rand(200) - 0.5) * np.pi
    scores = rng.rand(200, 1).astype(np.float32)
    det = nms_rotated(torch.from_numpy(rb)[None], torch.from_numpy(scores)[None], 0.05, 0.45, 64).numpy()[0]
    assert det.shape == (64, 7)
    conf = det[:, 5]
    assert (np.diff(conf[conf > 0]) <= 1e-6).all()
    assert (det[conf == 0, :5] == 0).all() and (det[conf == 0, 6] == -1).all()
    np.testing.assert_array_equal(det, np.asarray(jax_nms_rotated(jnp.asarray(rb)[None], jnp.asarray(scores)[None],
                                                                   0.05, 0.45, 64))[0])


def test_rotated_nms_suppresses_duplicates():
    """`tests/test_rotated_nms.py`'s second case: of a box, its near-duplicate and the same box written as w/h swapped
    at +pi/2, only the first survives; a far box survives too."""
    rb = np.array([[100, 100, 60, 20, 0.3], [100, 100, 60, 20, 0.31], [100, 100, 20, 60, 0.3 + np.pi / 2],
                   [400, 400, 60, 20, 1.0]], np.float32)
    scores = np.array([[0.9], [0.8], [0.7], [0.6]], np.float32)
    det = nms_rotated(torch.from_numpy(rb)[None], torch.from_numpy(scores)[None], 0.05, 0.45, 4).numpy()[0]
    kept = det[det[:, 5] > 0]
    assert len(kept) == 2 and np.allclose(sorted(kept[:, 5].tolist()), [0.6, 0.9])


def test_rotated_nms_keepsets_match_jax():
    """`tests/test_rotated_nms.py`'s third case, held to the JAX function (the reference is not in the repository):
    five trials of 120 single-class boxes at conf 0, as many kept and the same sorted scores."""
    rng = np.random.RandomState(3)
    for trial in range(5):
        rb = rand_rboxes(np.random.default_rng(trial), (120,))
        scores = (rng.rand(120).astype(np.float32) * 0.9 + 0.05).reshape(120, 1)
        ref = np.asarray(jax_nms_rotated(jnp.asarray(rb)[None], jnp.asarray(scores)[None], 0.0, 0.45, 120))[0]
        got = nms_rotated(torch.from_numpy(rb)[None], torch.from_numpy(scores)[None], 0.0, 0.45, 120).numpy()[0]
        assert (got[:, 5] > 0).sum() == (ref[:, 5] > 0).sum() > 30, f"trial {trial}"
        np.testing.assert_allclose(np.sort(got[got[:, 5] > 0, 5]), np.sort(ref[ref[:, 5] > 0, 5]), atol=1e-6)


# -- the rotated assigner and the OBB loss --------------------------------------------------------------------


NC, STRIDES = 5, (8.0, 16.0, 32.0)


def loss_case(seed, size=128):
    """Head maps (JAX NHWC), angles and padded rotated gts (B 2, M 8) in pixels, some rows padding."""
    rng = np.random.default_rng(seed)
    shapes = [(size // 8, size // 8), (size // 16, size // 16), (size // 32, size // 32)]
    maps = [rng.standard_normal((2, h, w, 64 + NC)).astype(np.float32) for h, w in shapes]
    A = sum(h * w for h, w in shapes)
    angle = ((rng.random((2, A, 1)) - 0.25) * np.pi).astype(np.float32)
    gt = rand_rboxes(rng, (2, 8), lo=12.0, hi=60.0, span=size - 40.0)
    mask = np.arange(8)[None] < np.array([[5], [8]])
    gt *= mask[..., None]
    lab = rng.integers(0, NC, (2, 8)).astype(np.int32)
    return maps, angle, lab, gt, mask


def test_rotated_assigner_matches_jax():
    """The rotated branch of `task_aligned_assigner` (point-in-rotated-rect candidates, probIoU overlaps) on seeded
    predictions and gts: fg_mask, target_gt_idx and target_labels equal to the JAX assigner's, the target rotated
    boxes bit for bit and the soft scores within 1e-6."""
    rng = np.random.default_rng(8)
    A, nc = 256, NC
    anc = np.stack(np.meshgrid(np.arange(16) + 0.5, np.arange(16) + 0.5, indexing="xy"), -1).reshape(-1, 2) * 8
    anc = anc.astype(np.float32)
    pd = np.concatenate([anc[None] + rng.normal(0, 4, (2, A, 2)), rng.uniform(10, 50, (2, A, 2)),
                         (rng.random((2, A, 1)) - 0.25) * np.pi], -1).astype(np.float32)
    scores = rng.random((2, A, nc)).astype(np.float32)
    _, _, lab, gt, mask = loss_case(9)
    ref = jax_assigner(*map(jnp.asarray, (scores, pd, anc, lab, gt, mask)), topk=10, num_classes=nc, rotated=True)
    got = task_aligned_assigner(*map(torch.from_numpy, (scores, pd, anc, lab, gt, mask)), topk=10, num_classes=nc,
                                rotated=True)
    assert int(got.fg_mask.sum()) > 20
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    fg = got.fg_mask.numpy()
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg], np.asarray(ref.target_gt_idx)[fg])
    np.testing.assert_array_equal(got.target_labels.numpy()[fg], np.asarray(ref.target_labels)[fg])
    np.testing.assert_array_equal(got.target_bboxes.numpy()[fg], np.asarray(ref.target_bboxes)[fg])
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores), rtol=0, atol=1e-6)


def port_obb_loss(maps, angle, lab, gt, mask, dtype=torch.float32):
    leaves = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_() for m in maps]
    ta = torch.from_numpy(angle).to(dtype).requires_grad_()
    out = {"feats": [(t[:, :64], t[:, 64:]) for t in leaves], "angle": ta}
    total, items = v8_obb_loss(out, *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC)
    total.backward()
    return total, items, [t.grad for t in leaves] + [ta.grad]


@pytest.mark.parametrize("seed", [10, 11])
def test_obb_loss_matches_jax(seed):
    """Total and the three items (box, cls, dfl) rtol 1e-5 / atol 1e-6 against the JAX `v8_obb_loss` (f32); the
    port's f32 gradients (head maps and angles) within 1e-4 of each one's largest of the port's f64 run."""
    maps, angle, lab, gt, mask = loss_case(seed)
    out = {"feats": tuple(jnp.asarray(m) for m in maps), "angle": jnp.asarray(angle)}
    ref_total, ref_items = jax.jit(lambda o, *t: jax_obb_loss(o, *t, STRIDES, NC))(out, *map(jnp.asarray, (lab, gt, mask)))
    total, items, g32 = port_obb_loss(maps, angle, lab, gt, mask)
    _, _, g64 = port_obb_loss(maps, angle, lab, gt, mask, torch.float64)
    assert items.shape == (3,) and not items.requires_grad and float(items[0]) > 0
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=1e-5, atol=1e-6)
    for a, b in zip(g32, g64):
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0, atol=1e-4 * float(b.abs().max()))


# -- yolov8n-obb through the entry points --------------------------------------------------------------


@pytest.fixture(scope="module")
def v8n_obb():
    """yolov8n-obb (nc 15) at full width: the JAX model and its seeded variables, with small boxes."""
    d = JC.yaml_model_load(JAX_CFG / "yolov8-obb.yaml")
    d.update(scale="n", nc=15)
    jm = jax_build(d)
    return jm, small_boxes(random_variables(jax_shapes(jm), seed=0))


@pytest.fixture
def jax_facade(v8n_obb, monkeypatch):
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: v8n_obb[1])
    return jax_model.YOLO


def frames(seed=11):
    """Square frames at imgsz (r = 1), so both letterboxes give byte-equal feeds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (S, S, 3), dtype=np.uint8) for _ in range(2)]


def test_predict_matches_jax_pipeline(v8n_obb, jax_facade):
    """YOLO("yolov8n-obb.yaml", nc=15).predict against the JAX facade's on the same weights, imgsz 64, conf 0.05: as
    many rows kept; `Results.obb` (n, 7) f32 [cx, cy, w, h, angle, conf, cls] in frame pixels, tie-tolerant as
    hull rows, each row's centre, w and h within 1e-3 px and its angle within 1e-4 rad of its JAX twin's; the boxes
    are the rows' hulls; indexing keeps the boxes only."""
    im = frames()
    jy = jax_facade("yolov8n-obb.yaml", nc=15)
    assert jy.task == "obb"
    yolo = YOLO("yolov8n-obb.yaml", device="cpu", seed=None, nc=15).load_flax(v8n_obb[1])
    ref = jy.predict(im, imgsz=S, batch=2, conf=0.05)
    results = yolo.predict(im, device="cpu", imgsz=S, batch=2, conf=0.05)
    for r, j, f in zip(results, ref, im):
        a, b = r.obb.data, np.asarray(j.obb.data)
        assert r.orig_shape == f.shape[:2] and a.dtype == np.float32 and len(a) == len(b) > 3
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-5)
        np.testing.assert_allclose(r.boxes.xyxy, r.obb.xyxy, rtol=0, atol=1e-3)
        for row in a:
            cand = b[(b[:, 6] == row[6]) & (np.abs(b[:, 5] - row[5]) <= 1e-5)]
            d = np.abs(cand[:, :4] - row[:4]).max(1)
            k = int(d.argmin())
            assert d[k] <= 1e-3 and abs(cand[k, 4] - row[4]) <= 1e-4
        assert r.obb.xyxyxyxy.shape == (len(a), 4, 2) and r.obb.xyxyxyxyn.shape == (len(a), 4, 2)
        assert len(r[0]) == 1 and r[0].obb is None and j[0].obb is None


def test_yolo_save_loads_in_both_packages(v8n_obb, jax_facade, tmp_path):
    """`YOLO.save` of a yolov8n-obb (nc 3) -> the JAX `YOLO(path)`: task "obb", the same variables bit for bit; its
    `save` -> the port's `YOLO(path)`: task "obb", the same weights and rotated rows."""
    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    yolo = YOLO("yolov8n-obb.yaml", device="cpu", seed=5, nc=3)
    jy = jax_facade(yolo.save(tmp_path / "port.ckpt"))
    assert (jy.model.nc, jy.task) == (3, "obb")
    ref, got = jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got[col]),
                                    jax.tree_util.tree_leaves_with_path(ref[col])):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = YOLO(jy.save(str(tmp_path / "jax.ckpt")), device="cpu")
    assert (back.model.nc, back.task) == (3, "obb")
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    im = frames(12)
    for r, o in zip(back.predict(im, imgsz=S, batch=2, conf=0.05, device="cpu"),
                    yolo.predict(im, imgsz=S, batch=2, conf=0.05, device="cpu")):
        np.testing.assert_array_equal(r.obb.data, o.obb.data)


VAL_SIDES = (64, 48, 56, 40, 64)


def write_obb_dataset(root: Path, jm, variables, per_frame: int = 3) -> Path:
    """Five square noise PNGs no larger than imgsz (the validator's scaleup=False only pads them), one without a
    label file; each label row is one of the JAX model's own rotated detections at the validator's settings (the
    strongest first, corners inside the frame) as a DOTA quad normalized by the frame's side."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    apply = jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True))
    for i, side in enumerate(VAL_SIDES):
        img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 3:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        pred = apply(variables, jnp.asarray(lb[None, ..., ::-1].astype(np.float32) / 255))["pred"]
        rb = jnp.concatenate([pred[..., :4], pred[..., -1:]], -1)
        det = np.asarray(jax_nms_rotated(rb, pred[..., 4:19], 0.001, 0.7, 300, multi_label=True))[0]
        lines = []
        for row in det[det[:, 5] > 0]:
            quad = (np.asarray(jax_corners(jnp.asarray(row[:5]))) - [pw, ph]) / side
            if quad.min() < 0 or quad.max() > 1:
                continue
            lines.append(f"{int(row[6])} " + " ".join(f"{v:.6f}" for v in quad.reshape(-1)))
            if len(lines) == per_frame:
                break
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 15}))
    return root / "data.yaml"


def test_val_matches_jax(v8n_obb, jax_facade, tmp_path):
    """YOLO("yolov8n-obb.yaml", nc=15).val(data=...) on square frames with DOTA quad labels equals the JAX
    YOLO.val's results dict (`assert_val_results_agree`): the box keys and fitness, matched by rotated probIoU."""
    data = write_obb_dataset(tmp_path, *v8n_obb)
    ref = jax_facade("yolov8n-obb.yaml", nc=15).val(data=str(data), imgsz=S, batch=4, workers=2)
    yolo = YOLO("yolov8n-obb.yaml", device="cpu", seed=None, nc=15).load_flax(v8n_obb[1])
    got = yolo.val(data=str(data), imgsz=S, batch=4, workers=2)
    assert list(got) == list(ref) and "metrics/mAP50-95(B)" in got
    assert ref["metrics/recall(B)"] > 0.5 and ref["metrics/mAP50-95(B)"] > 0.05
    assert_val_results_agree(got, ref)


def test_val_reads_the_kept_rows_past_max_gt(v8n_obb, jax_facade, tmp_path):
    """With more label rows than max_gt (3 rows, max_gt 2) the JAX validator's probIoU matrix takes every GT row
    (`_gt_rboxes`, engine/validator.py:188-200) against the first max_gt classes and raises on the broadcast
    (ROADMAP Queue 3); the port reads the kept rows only, so its results equal the JAX validator's on the same set
    with each label file cut to its first 2 rows."""
    data = write_obb_dataset(tmp_path / "full", *v8n_obb)
    rows = {f.name: f.read_text().splitlines() for f in (tmp_path / "full" / "labels" / "val").glob("*.txt")}
    assert max(len(r) for r in rows.values()) == 3
    with pytest.raises(ValueError, match="broadcast"):
        jax_facade("yolov8n-obb.yaml", nc=15).val(data=str(data), imgsz=S, batch=4, workers=2, max_gt=2)
    yolo = YOLO("yolov8n-obb.yaml", device="cpu", seed=None, nc=15).load_flax(v8n_obb[1])
    got = yolo.val(data=str(data), imgsz=S, batch=4, workers=2, max_gt=2)
    cut = write_obb_dataset(tmp_path / "cut", *v8n_obb, per_frame=2)
    ref = jax_facade("yolov8n-obb.yaml", nc=15).val(data=str(cut), imgsz=S, batch=4, workers=2, max_gt=2)
    assert_val_results_agree(got, ref)
    assert "metrics/mAP50-95(B)" in got


def write_rotated_set(root: Path) -> str:
    """The JAX test's rotated set (`tests/test_tasks.py:251-275`): 96 x 96 JPEGs with one filled 30 x 16 rectangle
    at 30 degrees each and its DOTA quad, 4 train and 2 val images, nc 1."""
    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("val", 2)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = rng.randint(90, 140, (96, 96, 3), np.uint8)
            rect = cv2.boxPoints(((48.0, 48.0), (30.0, 16.0), 30.0))
            cv2.fillPoly(img, [rect.astype(np.int32)], (60, 60, 220))
            pts = " ".join(f"{p[0] / 96:.4f} {p[1] / 96:.4f}" for p in rect)
            cv2.imwrite(str(root / "images" / split / f"im{i}.jpg"), img)
            (root / "labels" / split / f"im{i}.txt").write_text(f"0 {pts}\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "train": "images/train", "val": "images/val",
                                                    "nc": 1, "names": {0: "obj"}}))
    return str(root / "data.yaml")


def test_train_data_matches_jax_first_step(tmp_path, monkeypatch):
    """`YOLO("tests/assets/tiny-obb.yaml", nc=1).train(data=...)`: one epoch of b2 at imgsz 64, max_gt 4, on the JAX
    test's rotated set, as `tests/test_tasks.py::test_obb_train_loop` trains the JAX facade; results.csv has
    train/box, train/cls and train/dfl; both trainers take their first step on the same batch from the same seeded
    weights, and its three loss items (box, cls, dfl) agree within rtol 1e-4."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    data = write_rotated_set(tmp_path / "ds")
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: random_variables(jax_shapes(model), seed=0))
    first = {}

    def recording(module, key):
        make = module.make_train_step

        def wrapped(*a, **k):
            step = make(*a, **k)

            def run(state, batch):
                state, metrics = step(state, batch)
                first.setdefault(key, (np.asarray(metrics["items"]).copy(), np.asarray(batch["rboxes"]).copy()))
                return state, metrics
            return run
        monkeypatch.setattr(module, "make_train_step", wrapped)

    recording(jax_trainer, "jax")
    recording(port_trainer, "port")
    kw = dict(data=data, epochs=1, batch=2, imgsz=S, workers=0, max_gt=4, close_mosaic=0)
    jax_model.YOLO(str(TINY), nc=1).train(save_dir=str(tmp_path / "jax"), **kw)
    yolo = YOLO(TINY, device="cpu", seed=0, nc=1)
    assert yolo.task == "obb"
    yolo.train(save_dir=tmp_path / "run", device="cpu", **{**kw, "workers": 1})
    header = (tmp_path / "run" / "results.csv").read_text().splitlines()[0].split(",")
    assert header[:4] == ["epoch", "train/box", "train/cls", "train/dfl"]
    (jitems, jrb), (titems, trb) = first["jax"], first["port"]
    np.testing.assert_allclose(trb, jrb, rtol=0, atol=1e-5)
    assert titems.shape == (3,) and titems[0] > 0
    np.testing.assert_allclose(titems, jitems.reshape(-1)[:3], rtol=1e-4)
    assert all(np.isfinite(h["loss"]) and h["skipped"] is False for h in yolo.trainer.history)
