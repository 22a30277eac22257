"""The five YOLOv8 instance-segmentation scales (n/s/m/l/x-seg) of the port against the JAX package, on the CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree and reach the port through the weight bridge, as in `tests/test_torch_v8.py`
(whose docstring says why the box towers' last bias falls by 1 a DFL bin for
the entry points at imgsz 64).

* Each scale's graph: the YAML byte for byte, specs and save list (Proto's
  width npr scaled), the JAX parameter count (yolov8n-seg 3,409,952), the
  variable shapes, a strict load and the bridge's round trip, the conv3x3
  sites (the v8 ones and the 8 a Segment head adds).
* `Proto` with its transposed conv (flax's (kh, kw, out, in) kernel, no
  spatial flip; the seeded kernel is asymmetric) within 1e-5 of the largest
  value; the Segment head's (feats, mc, proto) in eval mode, after the
  serving fold and in train mode (with the new BN statistics) at the
  tolerances of `tests/test_torch_v8.py`.
* `crop_mask` and `process_mask` with and without upsample: max abs 1e-5.
* `v8_segmentation_loss`: total and items rtol 1e-5 / atol 1e-6 (the v8
  loss's), the port's f32 gradients within 1e-4 of the largest of its f64
  run's; and a case whose 160 foreground anchors tie in runs of 16 across
  the budget of 64, where the stable sort keeps `lax.top_k`'s order.
* yolov8n-seg at full width, imgsz 64: one train step of a narrow model
  against the JAX step, `predict` (boxes tie-tolerant, masks equal),
  `val(data=...)` (box and (M) keys equal) and `.ckpt` files both ways.
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
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.losses.segment import v8_segmentation_loss as jax_seg_loss
from lpc_yolo_tpu.nn import build_model as jax_build
from lpc_yolo_tpu.nn import compiler as JC
from lpc_yolo_tpu.nn.heads import Segment as JaxSegment
from lpc_yolo_tpu.nn.modules import Proto as JaxProto
from lpc_yolo_tpu.ops import masks as jmasks
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.ops.postprocess import non_max_suppression as jax_nms
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.losses import v8_segmentation_loss
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.nn.heads import Segment
from lpc_yolo_tpu_torch.ops.masks import crop_mask, process_mask
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v8"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v8"
S = 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}


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
def test_seg_scale_graph_matches_jax(scale):
    """`YOLO("yolov8<scale>-seg.yaml")` resolves to the port's copy of the JAX `v8/yolov8-seg.yaml`: task
    "segment"; the JAX `parse_model`'s specs (npr scaled by the width) and save list; the JAX parameter count
    and variable shapes; bridged weights loaded strictly and back to the JAX tree bit for bit; conv3x3 takes
    the v8 sites plus Proto's two 3x3 convs and two a level of the cv4 towers."""
    assert (PORT_CFG / "yolov8-seg.yaml").read_bytes() == (JAX_CFG / "yolov8-seg.yaml").read_bytes()
    yolo = YOLO(f"yolov8{scale}-seg.yaml", device="cpu", seed=None)
    assert yolo.task == "segment" and yolo.model_yaml["scale"] == scale
    specs, save = TC.parse_model(yolo.model_yaml)
    jd = JC.yaml_model_load(JAX_CFG / "yolov8-seg.yaml")
    jd["scale"] = scale
    jspecs, jsave = JC.parse_model(jd)
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    tm = yolo.model
    shapes = jax_shapes(jax_build(jd))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    if scale == "n":
        assert n_jax == 3_409_952  # tests/test_segment.py
    assert tm.strides == (8.0, 16.0, 32.0) and tm.task == "segment"
    bottlenecks = sum(s.args[2] for s in specs if s.module == "C2f")
    assert sum(isinstance(m, TM.ConvBN) and m.kernel_path for m in tm.modules()) == 2 * bottlenecks + 12 + 8
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


# -- Proto and the Segment head ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_proto_matches_jax(mode):
    """Proto (c1 24 -> npr 16 -> nm 8) on a 2x6x5 map: the 2x upsampled prototypes within 1e-5 of the largest
    value of the JAX module's, f32. The transposed conv's seeded kernel is asymmetric in both spatial axes,
    so a flipped kernel would not pass."""
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 24)).astype(np.float32)
    jp = JaxProto(16, 8)
    shapes = jax.eval_shape(lambda: jp.init(jax.random.PRNGKey(0), jnp.asarray(x), training=True))
    variables = random_variables(shapes, seed=3)
    k = variables["params"]["upsample"]["kernel"]
    assert k.shape == (2, 2, 16, 16)
    assert np.abs(k - k[::-1]).max() > 0.1 and np.abs(k - k[:, ::-1]).max() > 0.1
    tp = TM.Proto(24, 16, 8)
    tp.load_state_dict(flax_to_state_dict(variables), strict=True)
    if mode == "train":
        ref, _ = jp.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = tp.train()(_nchw(x))
    else:
        ref = jp.apply(variables, jnp.asarray(x), training=False)
        with torch.no_grad():
            got = tp.eval()(_nchw(x))
    ref = np.asarray(ref)
    assert got.shape == (2, 8, 12, 10) and ref.shape == (2, 12, 10, 8)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
def test_segment_head_matches_jax(mode):
    """yolov8n-seg's head (ch 64/128/256, nc 80, nm 32, npr 64) on 8x8/4x4/2x2 maps: the Detect pairs, mc
    (B, A, nm) and proto (B, nm, 16, 16) within atol 1e-5 of the JAX head's (feats, mc, proto) in eval mode,
    after `fuse_conv_bn` and in train mode; in train mode also the new BN statistics (rtol/atol 1e-5)."""
    ch, strides = (64, 128, 256), (8.0, 16.0, 32.0)
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, 8 >> i, 8 >> i, c)).astype(np.float32) for i, c in enumerate(ch)]
    jhead = JaxSegment(nc=80, nm=32, npr=64, ch=ch, strides=strides)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs], training=True))
    variables = random_variables(shapes, seed=0)
    head = Segment(nc=80, nm=32, npr=64, ch=ch, strides=strides)
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
    (feats, mc, proto), (rfeats, rmc, rproto) = got, ref
    for (box, cls), r in zip(feats, rfeats):
        maps = torch.cat([box, cls], 1).detach().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(maps, np.asarray(r), atol=1e-5, rtol=0)
    assert mc.shape == (2, 84, 32) and proto.shape == (2, 32, 16, 16)
    np.testing.assert_allclose(mc.detach().numpy(), np.asarray(rmc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(proto.detach().permute(0, 2, 3, 1).numpy(), np.asarray(rproto), atol=1e-5, rtol=0)


# -- the mask decode -----------------------------------------------------------------------------------


def test_crop_mask_matches_jax():
    rng = np.random.default_rng(4)
    masks = rng.random((5, 16, 20), dtype=np.float32)
    boxes = np.array([[0, 0, 20, 16], [2.5, 3.2, 7.5, 9.9], [-3, -2, 4, 5], [10, 10, 10, 12], [19.5, 15.5, 30, 30]],
                     np.float32)
    ref = np.asarray(jmasks.crop_mask(jnp.asarray(masks), jnp.asarray(boxes)))
    np.testing.assert_array_equal(crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes)).numpy(), ref)


@pytest.mark.parametrize("upsample", [False, True])
def test_process_mask_matches_jax(upsample):
    """sigmoid(coeffs @ protos), cropped to each box in proto pixels, and with upsample resized to the
    input as `jax.image.resize(..., "bilinear")`: max abs 1e-5 on the sigmoid masks."""
    rng = np.random.default_rng(5)
    protos = rng.standard_normal((16, 16, 32)).astype(np.float32)  # JAX NHWC (H4, W4, nm)
    coeffs = rng.standard_normal((7, 32)).astype(np.float32)
    xy = rng.uniform(-8, 56, (7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (7, 2))], 1).astype(np.float32)
    ref = np.asarray(jmasks.process_mask(jnp.asarray(protos), jnp.asarray(coeffs), jnp.asarray(boxes), (64, 64),
                                         upsample=upsample))
    got = process_mask(torch.from_numpy(protos.transpose(2, 0, 1).copy()), torch.from_numpy(coeffs),
                       torch.from_numpy(boxes), (64, 64), upsample=upsample).numpy()
    assert got.shape == ref.shape == ((7, 64, 64) if upsample else (7, 16, 16))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (ref > 0.5).any() and (ref == 0).any()


# -- the seg loss ----------------------------------------------------------------------------------------


NC, STRIDES = 5, (8.0, 16.0, 32.0)


def loss_case(seed, size, tied=False):
    """Head maps (JAX NHWC), mc, protos and padded gts with instance masks at size / 4. With `tied` the maps
    are zero (every anchor scores 0.5 and predicts the same box about itself) and 16 gts of 40 px lie on a
    64-px grid, so each gt's ten anchors have the same ten assigned scores: 160 foreground anchors tie in
    runs of 16 across the budget of 64."""
    rng = np.random.default_rng(seed)
    shapes = [(size // 8, size // 8), (size // 16, size // 16), (size // 32, size // 32)]
    maps = [rng.standard_normal((2, h, w, 64 + NC)).astype(np.float32) * (0 if tied else 1) for h, w in shapes]
    A = sum(h * w for h, w in shapes)
    mc = rng.standard_normal((2, A, 32)).astype(np.float32)
    proto = rng.standard_normal((2, size // 4, size // 4, 32)).astype(np.float32)
    M = 16
    if tied:
        g = np.array([(16 + 64 * i, 16 + 64 * j) for i in range(4) for j in range(4)], np.float32)
        gt = np.tile(np.concatenate([g, g + 40], 1)[None], (2, 1, 1))
        mask = np.ones((2, M), bool)
    else:
        xy = rng.uniform(0, size * 0.6, (2, M, 2))
        gt = np.concatenate([xy, xy + rng.uniform(6, size * 0.4, (2, M, 2))], -1).astype(np.float32)
        mask = np.arange(M)[None] < np.array([[5], [9]])
        gt *= mask[..., None]
    lab = rng.integers(0, NC, (2, M)).astype(np.int32)
    gm = (rng.random((2, M, size // 4, size // 4)) < 0.4).astype(np.uint8)
    return maps, mc, proto, lab, gt.astype(np.float32), mask, gm


def port_seg_loss(maps, mc, proto, lab, gt, mask, gm, dtype=torch.float32):
    leaves = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_() for m in maps]
    tmc = torch.from_numpy(mc).to(dtype).requires_grad_()
    tproto = torch.from_numpy(proto.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_()
    out = {"feats": [(t[:, :64], t[:, 64:]) for t in leaves], "mc": tmc, "proto": tproto}
    total, items = v8_segmentation_loss(out, *map(torch.from_numpy, (lab, gt, mask, gm)), STRIDES, NC)
    total.backward()
    return total, items, [t.grad for t in leaves] + [tmc.grad, tproto.grad]


@pytest.mark.parametrize("tied", [False, True])
def test_seg_loss_matches_jax(tied):
    """Total and the four items (box, seg, cls, dfl) rtol 1e-5 / atol 1e-6 against the JAX loss; the port's f32
    gradients (head maps, mc, protos) within 1e-4 of each one's largest of the port's f64 run. In the tied case
    the 64th and 65th foreground scores are equal, so the budget's cut keeps the lower anchors, as
    `lax.top_k` does."""
    maps, mc, proto, lab, gt, mask, gm = loss_case(6, 256 if tied else 64, tied)
    out = {"feats": tuple(jnp.asarray(m) for m in maps), "mc": jnp.asarray(mc), "proto": jnp.asarray(proto)}
    ref_total, ref_items = jax.jit(lambda o, *t: jax_seg_loss(o, *t, STRIDES, NC))(
        out, *map(jnp.asarray, (lab, gt, mask, gm)))
    total, items, g32 = port_seg_loss(maps, mc, proto, lab, gt, mask, gm)
    _, _, g64 = port_seg_loss(maps, mc, proto, lab, gt, mask, gm, torch.float64)
    assert items.shape == (4,) and not items.requires_grad
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=1e-5, atol=1e-6)
    assert float(items[1]) > 0
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0, atol=1e-4 * float(b.abs().max()))
    if tied:
        from lpc_yolo_tpu_torch.losses.detection import flatten_maps, v8_detection_loss

        feats = [(torch.from_numpy(m.transpose(0, 3, 1, 2)[:, :64].copy()),
                  torch.from_numpy(m.transpose(0, 3, 1, 2)[:, 64:].copy())) for m in maps]
        assign = v8_detection_loss(feats, *map(torch.from_numpy, (lab, gt, mask)), STRIDES, NC, return_assign=True)[2]
        score = (assign.target_scores.sum(-1) * assign.fg_mask).sort(1, descending=True).values
        assert int(assign.fg_mask[0].sum()) == 160 and float(score[0, 63]) == float(score[0, 64]) > 0
        assert flatten_maps(feats)[0].shape[1] == 1344


# -- yolov8n-seg through the entry points --------------------------------------------------------------


@pytest.fixture(scope="module")
def v8n_seg():
    """yolov8n-seg at full width: the JAX model and its seeded variables, with small boxes."""
    jm = jax_build(JAX_CFG / "yolov8-seg.yaml")
    return jm, small_boxes(random_variables(jax_shapes(jm), seed=0))


@pytest.fixture
def jax_facade(v8n_seg, monkeypatch):
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: v8n_seg[1])
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


def test_predict_matches_jax_pipeline(v8n_seg, jax_facade):
    """YOLO("yolov8n-seg.yaml").predict against the JAX facade's on the same weights, imgsz 64, conf 1e-4: boxes
    tie-tolerant (box 1e-3, score 1e-6), as many kept; every row's (h0, w0) bool mask equal to the JAX mask
    of its twin row. (A pixel may flip only where the mask's value lies within ~1e-6 of 0.5; none does here.)"""
    im = frames()
    jy = jax_facade("yolov8n-seg.yaml")
    assert jy.task == "segment"
    yolo = YOLO("yolov8n-seg.yaml", device="cpu", seed=None).load_flax(v8n_seg[1])
    ref = jy.predict(im, imgsz=S, batch=2, conf=1e-4)
    results = yolo.predict(im, device="cpu", imgsz=S, batch=2, conf=1e-4)
    n_masks = 0
    for r, j, f in zip(results, ref, im):
        a, b = r.boxes.data, np.asarray(j.boxes.data)
        assert r.orig_shape == f.shape[:2] and len(a) == len(b) > 10
        assert_detections_close(a, b, atol_box=1e-3, atol_score=1e-6)
        assert r.masks.shape == (len(a),) + f.shape[:2] and r.masks.dtype == bool
        pairs = match_rows(a, b)
        assert len(pairs) >= len(a) - 2
        for i, k in pairs:
            np.testing.assert_array_equal(r.masks[i], np.asarray(j.masks.data[k]))
        n_masks += int(r.masks.data.sum())
    assert n_masks > 100


def test_yolo_save_loads_in_both_packages(v8n_seg, jax_facade, tmp_path):
    """`YOLO.save` of a yolov8n-seg (nc 3) -> the JAX `YOLO(path)`: task "segment", the same variables bit for bit;
    its `save` -> the port's `YOLO(path)`: task "segment", the same weights and the same masks."""
    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    yolo = YOLO("yolov8n-seg.yaml", device="cpu", seed=5, nc=3)
    jy = jax_facade(yolo.save(tmp_path / "port.ckpt"))
    assert (jy.model.nc, jy.task) == (3, "segment")
    ref, got = jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got[col]),
                                    jax.tree_util.tree_leaves_with_path(ref[col])):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = YOLO(jy.save(str(tmp_path / "jax.ckpt")), device="cpu")
    assert (back.model.nc, back.task) == (3, "segment")
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    im = frames(12)
    for r, o in zip(back.predict(im, imgsz=S, batch=2, conf=1e-4, device="cpu"),
                    yolo.predict(im, imgsz=S, batch=2, conf=1e-4, device="cpu")):
        np.testing.assert_array_equal(r.boxes.data, o.boxes.data)
        np.testing.assert_array_equal(r.masks.data, o.masks.data)


def write_seg_dataset(root: Path, jm, variables) -> Path:
    """Five noise PNGs no larger than imgsz (the validator's scaleup=False only pads them, so both letterboxes
    give byte-equal feeds), one without a label file; each label is one of the JAX model's own detections at
    the validator's settings (the strongest of its class, inside the frame) with, as its polygon, the largest
    outer contour of that detection's JAX mask (cv2.findContours), so mask IoUs are far from 0."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    apply = jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True))
    for i, (h0, w0) in enumerate(((48, 40), (64, 64), (50, 64), (32, 56), (40, 40))):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 3:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        out = apply(variables, jnp.asarray(lb[None, ..., ::-1].astype(np.float32) / 255))
        det, aidx = jax_nms(out["pred"], 0.001, 0.7, 300, multi_label=True, return_anchor_idx=True)
        det, mc = np.asarray(det[0]), np.asarray(out["mc"][0])[np.asarray(aidx[0])]
        masks = np.asarray(jmasks.process_mask(out["proto"][0], jnp.asarray(mc), det[:, :4], (S, S), upsample=True))
        lines, seen = [], set()
        for row, m in zip(det, masks):
            c = int(row[5])
            if row[5] < 0 or c in seen or min(row[0] - pw, row[1] - ph, pw + w0 - row[2], ph + h0 - row[3]) < 0:
                continue
            cs = cv2.findContours((m > 0.5).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
            if not cs or len(max(cs, key=len)) < 3:
                continue
            seen.add(c)
            poly = (max(cs, key=len).reshape(-1, 2) - [pw, ph]) / [w0, h0]
            lines.append(f"{c} " + " ".join(f"{x:.6f} {y:.6f}" for x, y in poly))
            if len(lines) == 3:
                break
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 80}))
    return root / "data.yaml"


def test_val_matches_jax(v8n_seg, jax_facade, tmp_path):
    """YOLO("yolov8n-seg.yaml").val(data=...) on polygon labels agrees with the JAX YOLO.val's results dict
    (`assert_val_results_agree`): the box keys, fitness and the four (M) keys (mask IoU of the decoded masks > 0.5 at imgsz
    against the polygons filled by `fill_poly`)."""
    data = write_seg_dataset(tmp_path, *v8n_seg)
    ref = jax_facade("yolov8n-seg.yaml").val(data=str(data), imgsz=S, batch=4, workers=2)
    got = YOLO("yolov8n-seg.yaml", device="cpu", seed=None).load_flax(v8n_seg[1]).val(
        data=str(data), imgsz=S, batch=4, workers=2)
    assert list(got) == list(ref) and "metrics/mAP50-95(M)" in got
    assert ref["metrics/mAP50(M)"] > 0.1  # the labels are the JAX model's own masks
    assert_val_results_agree(got, ref)


# -- a train step of a narrow yolov8n-seg ---------------------------------------------------------------


def narrow_yaml(nc: int = 4) -> dict:
    d = yaml.safe_load((PORT_CFG / "yolov8-seg.yaml").read_text())
    d.update(nc=nc, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    return d


def make_batch(seed: int) -> dict:
    """f32 RGB frames in [0, 1], padded gts and their instance masks at 16x16."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (2, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (2, 4, 2))], -1).astype(np.float32)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    masks = np.zeros((2, 4, 16, 16), np.uint8)
    for b, g in zip(*np.nonzero(mask)):
        x1, y1, x2, y2 = (boxes[b, g] / 4).astype(int)
        masks[b, g, y1:y2 + 1, x1:x2 + 1] = 1
    return {"img": rng.random((2, S, S, 3), dtype=np.float32), "cls": rng.integers(0, 4, (2, 4)).astype(np.int32),
            "bboxes": boxes * mask[..., None], "mask": mask, "masks": masks}


def port_first_trace(tm, batch, dtype, cfg):
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
    """The seg loss (4 items) through the JAX step (loss_kind "segment") and the port's: loss and items rtol
    1e-4; the first momentum trace at the tolerances of `tests/test_torch_v8.py` (JAX within 1e-2 of each
    leaf's largest of the port's f64 run, the port's f32 within 2e-3 of it); then two steps of the port's
    own step, every leaf finite."""
    d = narrow_yaml()
    jm = jax_build(d)
    variables = random_variables(jax_shapes(jm), seed=0)
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="segment").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    assert np.asarray(jmet["items"]).shape == (4,)
    total, items, t32 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float32, tcfg)
    _, _, t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64, tcfg)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)

    tm = load_flax(build_model(d, device="cpu"), variables)
    state = tts.init_train_state(tm, tcfg, device="cpu")
    step = tts.make_train_step(tm, tcfg, loss_kind="segment")
    for i in range(2):
        state, met = step(state, make_batch(i))
        assert met["items"].shape == (4,) and met["skipped"] is False
    assert all(torch.isfinite(v).all() for v in state.params.values())
