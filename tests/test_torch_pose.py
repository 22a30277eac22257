"""The five YOLOv8 pose scales (n/s/m/l/x-pose) of the port against the JAX package, on the CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree and reach the port through the weight bridge, as in `tests/test_torch_v8.py`
(whose docstring says why the box towers' last bias falls by 1 a DFL bin for
the entry points at imgsz 64).

* Each scale's graph: the YAML byte for byte, task "pose", specs and save list
  (`kpt_shape` taken from the YAML), the JAX parameter count (yolov8n-pose
  3,295,454 to yolov8x-pose 69,491,708), the variable shapes, a strict load
  and the bridge's round trip, the conv3x3 sites (the v8 ones and the 6 of the
  keypoint towers).
* The Pose head's (feats, raw keypoints) in eval mode, after the serving fold
  and in train mode (with the new BN statistics), at the tolerances of
  `tests/test_torch_v8.py`, for kpt_shape (17, 3) and (5, 2); `decode_kpts`
  for ndim 3 and 2 within 1e-5 of the largest value.
* yolov8n-pose at full width, imgsz 64: `predict` (boxes tie-tolerant,
  keypoints of matched rows within 1e-4 px), `.ckpt` files of task "pose"
  both ways, `val(data=...)` (box and (P) keys as `assert_val_results_agree` holds them), and
  the pose `max_gt` fault of the JAX validator (its OKS matrix takes every GT
  row; the port's the kept ones).
* A kpt_shape of ndim 2: the head and decode run in both packages; the JAX
  predictor reshapes by nk // 3 and its OKS reads a visibility column, so the
  port's `predict` and `val` raise NotImplementedError.
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
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn.heads import Pose as JaxPose
from lpc_yolo_tpu.nn.heads import decode_kpts as jax_decode_kpts
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.ops.postprocess import non_max_suppression as jax_nms
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.nn.heads import Pose, decode_kpts
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, random_variables

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v8"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
PARAMS = {"n": 3_295_454, "s": 11_626_030, "m": 26_464_446, "l": 44_489_180, "x": 69_491_708}
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# -- the graphs ----------------------------------------------------------------------------------


@pytest.mark.parametrize("scale", list("nsmlx"))
def test_pose_scale_graph_matches_jax(scale):
    """`YOLO("yolov8<scale>-pose.yaml")` resolves to the port's copy of the JAX `v8/yolov8-pose.yaml`: task "pose";
    the JAX `parse_model`'s specs (kpt_shape (17, 3) from the YAML) and save list; the JAX parameter count and
    variable shapes; bridged weights loaded strictly and back to the JAX tree bit for bit (the cv4 towers
    included); conv3x3 takes the v8 sites plus two a level of the keypoint towers, whose width is 51 on n, s
    and m."""
    assert (PORT_CFG / "yolov8-pose.yaml").read_bytes() == (JAX_CFG / "yolov8-pose.yaml").read_bytes()
    yolo = YOLO(f"yolov8{scale}-pose.yaml", device="cpu", seed=None)
    assert yolo.task == "pose" and yolo.model_yaml["scale"] == scale
    specs, save = TC.parse_model(yolo.model_yaml)
    jd = JC.yaml_model_load(JAX_CFG / "yolov8-pose.yaml")
    jd["scale"] = scale
    jspecs, jsave = JC.parse_model(jd)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    assert specs[-1].module == "Pose" and specs[-1].args[1] == (17, 3)
    tm = yolo.model
    shapes = jax_shapes(jax_build(jd))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax == PARAMS[scale]
    assert tm.strides == (8.0, 16.0, 32.0) and tm.model[-1].kpt_shape == (17, 3)
    c4 = tm.model[-1].cv4[0][0].conv.out_channels
    assert c4 == {"n": 51, "s": 51, "m": 51, "l": 64, "x": 80}[scale]
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


# -- the Pose head and the keypoint decode -------------------------------------------------------------------


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["17x3", "5x2"])
@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_pose_head_matches_jax(mode, kpt_shape):
    """yolov8n-pose's head (ch 64/128/256, nc 1) on 8x8/4x4/2x2 maps: the Detect pairs and the raw keypoints
    (B, A, nk) within atol 1e-5 of the JAX head's (feats, kpt) in eval mode, after `fuse_conv_bn` and in train
    mode; in train mode also the new BN statistics (rtol/atol 1e-5)."""
    ch, strides = (64, 128, 256), (8.0, 16.0, 32.0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jhead = JaxPose(nc=1, kpt_shape=kpt_shape, ch=ch, strides=strides)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs], training=True))
    variables = random_variables(shapes, seed=0)
    head = Pose(nc=1, kpt_shape=kpt_shape, ch=ch, strides=strides)
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
    (feats, kpt), (rfeats, rkpt) = got, ref
    for (box, cls), r in zip(feats, rfeats):
        maps = torch.cat([box, cls], 1).detach().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(maps, np.asarray(r), atol=1e-5, rtol=0)
    assert kpt.shape == (2, 84, kpt_shape[0] * kpt_shape[1])
    np.testing.assert_allclose(kpt.detach().numpy(), np.asarray(rkpt), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kpt_shape", [(17, 3), (12, 2)], ids=["17x3", "12x2"])
def test_decode_kpts_matches_jax(kpt_shape):
    """xy = (raw * 2 + anchor - 0.5) * stride over three levels of a 96 input, and with ndim 3 the sigmoid
    visibility: within 1e-5 of the largest value of the JAX decode's."""
    shapes = [(12, 12), (6, 6), (3, 3)]
    A = sum(h * w for h, w in shapes)
    raw = np.random.default_rng(2).standard_normal((2, A, kpt_shape[0] * kpt_shape[1])).astype(np.float32) * 3
    ref = np.asarray(jax_decode_kpts(jnp.asarray(raw), shapes, (8.0, 16.0, 32.0), kpt_shape))
    got = decode_kpts(torch.from_numpy(raw), shapes, (8.0, 16.0, 32.0), kpt_shape).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if kpt_shape[1] == 3:
        vis = got.reshape(2, A, *kpt_shape)[..., 2]
        assert (vis > 0).all() and (vis < 1).all()


# -- yolov8n-pose through the entry points --------------------------------------------------------------


@pytest.fixture(scope="module")
def v8n_pose():
    """yolov8n-pose at full width: the JAX model and its seeded variables, with small boxes."""
    jm = jax_build(JAX_CFG / "yolov8-pose.yaml")
    return jm, small_boxes(random_variables(jax_shapes(jm), seed=0))


@pytest.fixture
def jax_facade(v8n_pose, monkeypatch):
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: v8n_pose[1])
    return jax_model.YOLO


def frames(seed=11):
    """Frames that need no resize at imgsz 64 (r = 1), so both letterboxes give byte-equal feeds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (48, 64, 3))]


def match_rows(a: np.ndarray, b: np.ndarray):
    """Index pairs (i, j) of rows of a and b with the same label, scores within 1e-6 and boxes within 1e-3."""
    pairs = []
    for i, row in enumerate(a):
        d = np.abs(b[:, :4] - row[:4]).max(1)
        cand = np.nonzero((b[:, 5] == row[5]) & (np.abs(b[:, 4] - row[4]) <= 1e-6) & (d <= 1e-3))[0]
        if len(cand):
            pairs.append((i, int(cand[d[cand].argmin()])))
    return pairs


def test_predict_matches_jax_pipeline(v8n_pose, jax_facade):
    """YOLO("yolov8n-pose.yaml").predict against the JAX facade's on the same weights, imgsz 64, conf 1e-4: boxes
    tie-tolerant (box 1e-3, score 1e-6), as many kept; every row's (17, 3) f32 keypoints in frame pixels within
    1e-4 px (and 1e-5 in visibility) of its JAX twin row's. Some keypoints lie off the frame: neither package
    clips them."""
    im = frames()
    jy = jax_facade("yolov8n-pose.yaml")
    assert jy.task == "pose"
    yolo = YOLO("yolov8n-pose.yaml", device="cpu", seed=None).load_flax(v8n_pose[1])
    ref = jy.predict(im, imgsz=S, batch=2, conf=1e-4)
    results = yolo.predict(im, device="cpu", imgsz=S, batch=2, conf=1e-4)
    n_pts, off = 0, 0
    for r, j, f in zip(results, ref, im):
        a, b = r.boxes.data, np.asarray(j.boxes.data)
        assert r.orig_shape == f.shape[:2] and len(a) == len(b) > 3
        assert_detections_close(a, b, atol_box=1e-3, atol_score=1e-6)
        assert isinstance(r.keypoints, np.ndarray) and r.keypoints.shape == (len(a), 17, 3)
        assert r.keypoints.dtype == np.float32 and np.asarray(j.keypoints).shape == (len(b), 17, 3)
        pairs = match_rows(a, b)
        assert len(pairs) >= len(a) - 2
        for i, k in pairs:
            np.testing.assert_allclose(r.keypoints[i, :, :2], np.asarray(j.keypoints)[k, :, :2], rtol=0, atol=1e-4)
            np.testing.assert_allclose(r.keypoints[i, :, 2], np.asarray(j.keypoints)[k, :, 2], rtol=0, atol=1e-5)
        n_pts += r.keypoints[..., 0].size
        off += int(((r.keypoints[..., 0] < 0) | (r.keypoints[..., 0] > f.shape[1])).sum())
        # indexing takes the boxes only, as in the JAX Results (:281-285)
        assert r[0].boxes.data.shape == (1, 6) and r[0].keypoints is None and j[0].keypoints is None
    assert n_pts > 100 and off > 0


def test_yolo_save_loads_in_both_packages(v8n_pose, jax_facade, tmp_path):
    """`YOLO.save` of a yolov8n-pose (nc 3) -> the JAX `YOLO(path)`: task "pose", kpt_shape (17, 3), the same
    variables bit for bit; its `save` -> the port's `YOLO(path)`: task "pose", the same weights, boxes and
    keypoints."""
    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    yolo = YOLO("yolov8n-pose.yaml", device="cpu", seed=5, nc=3)
    jy = jax_facade(yolo.save(tmp_path / "port.ckpt"))
    assert (jy.model.nc, jy.task) == (3, "pose")
    assert tuple(jy.model.specs[-1].args[1]) == (17, 3)
    ref, got = jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got[col]),
                                    jax.tree_util.tree_leaves_with_path(ref[col])):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = YOLO(jy.save(str(tmp_path / "jax.ckpt")), device="cpu")
    assert (back.model.nc, back.task, back.model.model[-1].kpt_shape) == (3, "pose", (17, 3))
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    im = frames(12)
    for r, o in zip(back.predict(im, imgsz=S, batch=2, conf=1e-4, device="cpu"),
                    yolo.predict(im, imgsz=S, batch=2, conf=1e-4, device="cpu")):
        np.testing.assert_array_equal(r.boxes.data, o.boxes.data)
        np.testing.assert_array_equal(r.keypoints, o.keypoints)


VAL_SHAPES = ((48, 40), (64, 64), (50, 64), (32, 56), (40, 40))


def write_pose_dataset(root: Path, jm, variables, per_frame: int = 3) -> Path:
    """Five noise PNGs no larger than imgsz (the validator's scaleup=False only pads them, so both letterboxes
    give byte-equal feeds), one without a label file; each label row is one of the JAX model's own detections
    at the validator's settings (boxes inside the frame, the strongest first) with its 17 decoded keypoints,
    visibility 2 inside the frame and 0 outside, so OKS are far from 0."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    apply = jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True))
    for i, (h0, w0) in enumerate(VAL_SHAPES):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 3:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        out = apply(variables, jnp.asarray(lb[None, ..., ::-1].astype(np.float32) / 255))
        det, aidx = jax_nms(out["pred"], 0.001, 0.7, 300, multi_label=True, return_anchor_idx=True)
        det, kpt = np.asarray(det[0]), np.asarray(out["kpt"][0])[np.asarray(aidx[0])].reshape(-1, 17, 3)
        lines = []
        for row, kp in zip(det, kpt):
            if row[5] < 0 or min(row[0] - pw, row[1] - ph, pw + w0 - row[2], ph + h0 - row[3]) < 0:
                continue
            x1, y1, x2, y2 = (row[:4] - [pw, ph, pw, ph]) / [w0, h0, w0, h0]
            x, y = (kp[:, 0] - pw) / w0, (kp[:, 1] - ph) / h0
            v = np.where((x >= 0) & (x <= 1) & (y >= 0) & (y <= 1), 2, 0)
            pts = " ".join(f"{a:.6f} {b:.6f} {c}" for a, b, c in zip(x, y, v))
            lines.append(f"{int(row[5])} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f} {pts}")
            if len(lines) == per_frame:
                break
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 1,
                                                    "kpt_shape": [17, 3]}))
    return root / "data.yaml"


def test_val_matches_jax(v8n_pose, jax_facade, tmp_path):
    """YOLO("yolov8n-pose.yaml").val(data=...) on keypoint labels agrees with the JAX YOLO.val's results dict as
    `assert_val_results_agree` holds it: the box keys, fitness (the box fitness) and the four (P) keys (OKS of each
    kept row's keypoints against the labels', area the GT box's times 0.53)."""
    data = write_pose_dataset(tmp_path, *v8n_pose)
    ref = jax_facade("yolov8n-pose.yaml").val(data=str(data), imgsz=S, batch=4, workers=2)
    yolo = YOLO("yolov8n-pose.yaml", device="cpu", seed=None).load_flax(v8n_pose[1])
    got = yolo.val(data=str(data), imgsz=S, batch=4, workers=2)
    assert list(got) == list(ref)
    assert [k for k in got if k.endswith("(P)")] == ["metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)",
                                                     "metrics/mAP50-95(P)"]
    # the labels are the JAX model's own keypoints: every one is found; higher-scoring rows off the labels keep
    # the precision of the random weights low
    assert ref["metrics/recall(P)"] == 1.0 and ref["metrics/mAP50-95(P)"] > 0.05
    assert_val_results_agree(got, ref)


def test_val_reads_the_kept_rows_past_max_gt(v8n_pose, jax_facade, tmp_path):
    """With more label rows than max_gt (3 rows, max_gt 2) the JAX validator's OKS takes every GT row against
    the kept boxes' areas and raises on the broadcast (ROADMAP Queue 3); the port reads the kept rows only, so
    its results equal the JAX validator's on the same set with each label file cut to its first 2 rows."""
    data = write_pose_dataset(tmp_path / "full", *v8n_pose)
    rows = {f.name: f.read_text().splitlines() for f in (tmp_path / "full" / "labels" / "val").glob("*.txt")}
    assert max(len(r) for r in rows.values()) == 3
    with pytest.raises(ValueError):
        jax_facade("yolov8n-pose.yaml").val(data=str(data), imgsz=S, batch=4, workers=2, max_gt=2)
    got = YOLO("yolov8n-pose.yaml", device="cpu", seed=None).load_flax(v8n_pose[1]).val(
        data=str(data), imgsz=S, batch=4, workers=2, max_gt=2)
    cut = write_pose_dataset(tmp_path / "cut", *v8n_pose, per_frame=2)
    ref = jax_facade("yolov8n-pose.yaml").val(data=str(cut), imgsz=S, batch=4, workers=2, max_gt=2)
    assert_val_results_agree(got, ref)
    assert "metrics/mAP50-95(P)" in got




@pytest.mark.parametrize("kpt_shape", [(5, 2), (12, 2)], ids=["5x2", "12x2"])
def test_ndim2_predict_and_val_refused(kpt_shape, tmp_path, monkeypatch):
    """A kpt_shape of ndim 2: the JAX predictor reshapes each row's keypoints by nk // 3 (predictor.py:344), so for
    (5, 2) it raises and for (12, 2) it returns (n, 8, 3); its OKS reads gt[..., 2] (metrics.py:306), which
    raises. The port's head runs, and its `predict` and `val` raise NotImplementedError naming those lines.
    (yolov8n-pose at full width: the JAX deploy graph refuses narrow widths, ROADMAP Queue 3.)"""
    import lpc_yolo_tpu.engine.model as jax_model

    d = yaml.safe_load((PORT_CFG / "yolov8-pose.yaml").read_text())
    d.update(kpt_shape=list(kpt_shape), scale="n")
    path = tmp_path / "yolov8n-pose2.yaml"
    path.write_text(yaml.safe_dump(d))
    jm = jax_build(yaml.safe_load(path.read_text()))
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: random_variables(jax_shapes(jm), seed=0))
    jy = jax_model.YOLO(str(path))
    im = frames()[:1]
    if kpt_shape[0] * kpt_shape[1] % 3:
        with pytest.raises(ValueError):
            jy.predict(im, imgsz=S, conf=1e-4)
    else:
        kp = np.asarray(jy.predict(im, imgsz=S, conf=1e-4)[0].keypoints)
        assert kp.shape[1:] == (kpt_shape[0] * kpt_shape[1] // 3, 3)
    yolo = YOLO(path, device="cpu", seed=0)
    with torch.no_grad():
        out = yolo.model(torch.zeros(1, 3, S, S))
    assert out["kpt"].shape == (1, 84, kpt_shape[0] * kpt_shape[1])
    with pytest.raises(NotImplementedError, match="predictor.py:344"):
        yolo.predict(im, imgsz=S, device="cpu")
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    cv2.imwrite(str(tmp_path / "images" / "a.png"), im[0])
    xy = " ".join(f"{0.3 + 0.04 * k:.6f} {0.6 - 0.03 * k:.6f}" for k in range(kpt_shape[0]))
    (tmp_path / "labels" / "a.txt").write_text(f"0 0.5 0.5 0.4 0.5 {xy}\n")
    data = {"path": str(tmp_path), "val": "images", "nc": 1, "kpt_shape": list(kpt_shape)}
    with pytest.raises(IndexError):
        jy.val(data=data, imgsz=S, batch=1, workers=1)
    with pytest.raises(NotImplementedError, match="metrics.py:306"):
        yolo.val(data=data, imgsz=S, batch=1, workers=1)
