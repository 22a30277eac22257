"""The six YOLOv10 scales (n/s/m/b/l/x) of the port against the JAX package, on the CPU in f32.

Weights come from `random_variables` over the JAX module's `jax.eval_shape`
tree (seeded numpy, no init FLOPs) and reach the port through the weight
bridge, so both packages run the same numbers.

* The four v10 blocks (SCDown, RepVGGDW, CIB, C2fCIB) and PSA at v10m's and
  v10x's head counts, in eval mode, after the serving fold and in train mode
  (outputs atol 1e-5, as `tests/test_torch_blocks.py`; new BN statistics
  rtol/atol 1e-5, as `tests/test_torch_train.py`), and their gradients of
  sum(out * r) against the port run in f64 (input and every parameter within
  1e-4 of each leaf's largest value, floor 1e-5 for the BN biases that a later
  train-mode BN cancels, whose true gradient is 0).
* Each scale's graph without FLOPs: layer specs, save list, parameter count
  (`tests/test_models.py`), a strict load of bridged weights and the bridge's
  round trip bit for bit.
* Whole-model detections of yolov10n and yolov10m at full width, imgsz 64;
  yolov10n's `predict` against the JAX `YOLO.predict`, its `val` results dict
  against the JAX validator's, and `.ckpt` files both ways. These three use
  yolov10n at its full width (2.8 M parameters): the JAX serving and
  validation graph (the deploy graph, width-packed) refuses the narrow one
  at 64 (`packed_conv_grouped_out` asserts), as it packs the narrow LPC
  graph wrongly (`tests/test_torch_ckpt.py`).
* One train step on a narrow yolov10n (widths 8-64, nc 4, batch 2): loss,
  items and the first momentum trace against the JAX step, compiled once
  with XLA's fusion pass off, at the tolerances of `tests/test_torch_train.py`.
"""

import dataclasses
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
from lpc_yolo_tpu.nn import modules as JM
from lpc_yolo_tpu.ops.letterbox import letterbox_image
from lpc_yolo_tpu.utils.torch_port import port_state_dict

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.nn import compiler as TC
from lpc_yolo_tpu_torch.nn import modules as TM
from lpc_yolo_tpu_torch.nn.fuse import fuse_conv_bn
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close, assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables
from lpc_yolo_tpu_torch.utils.metrics import box_iou_np

ROOT = Path(__file__).resolve().parents[1]
JAX_CFG = ROOT / "lpc_yolo_tpu" / "cfg" / "models" / "v10"
PORT_CFG = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10"
PARAMS = {"n": 2_775_504, "s": 8_128_256, "m": 16_576_752, "b": 20_574_368, "l": 25_888_672, "x": 31_808_944}
S = 64
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The blocks and the narrow model are small: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def seeded(jmod, shape, seed=0):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(shape), training=False))
    return random_variables(shapes, seed)


# -- the blocks ----------------------------------------------------------------------------------

# (name, factory of (JAX module, port module), NHWC input shape)
BLOCKS = [
    ("scdown", lambda: (JM.SCDown(32, 3, 2), TM.SCDown(24, 32, 3, 2)), (2, 8, 8, 24)),
    ("repvggdw", lambda: (JM.RepVGGDW(16), TM.RepVGGDW(16)), (2, 8, 8, 16)),
    ("cib_lk_shortcut", lambda: (JM.CIB(16, True, e=1.0, lk=True), TM.CIB(16, 16, True, e=1.0, lk=True)),
     (2, 8, 8, 16)),
    ("cib_lk", lambda: (JM.CIB(16, False, e=1.0, lk=True), TM.CIB(16, 16, False, e=1.0, lk=True)), (2, 8, 8, 16)),
    ("cib_shortcut", lambda: (JM.CIB(16, True, e=0.5), TM.CIB(16, 16, True, e=0.5)), (2, 8, 8, 16)),
    ("cib_plain", lambda: (JM.CIB(24, True, e=0.5), TM.CIB(16, 24, True, e=0.5)), (2, 8, 8, 16)),  # c1 != c2: no add
    ("c2fcib_lk", lambda: (JM.C2fCIB(32, n=2, shortcut=True, lk=True), TM.C2fCIB(24, 32, 2, True, True)),
     (2, 8, 8, 24)),
    ("c2fcib", lambda: (JM.C2fCIB(32, n=2, shortcut=True), TM.C2fCIB(24, 32, 2, True)), (2, 8, 8, 24)),
    ("psa_4heads_hd72", lambda: (JM.PSA(576), TM.PSA(576, 576)), (2, 4, 4, 576)),  # v10m's: c 288
    ("psa_5heads_hd64", lambda: (JM.PSA(640), TM.PSA(640, 640)), (2, 4, 4, 640)),  # v10x's: c 320
]
IDS = [b[0] for b in BLOCKS]


def test_block_structure():
    """Mish in SCDown's 1x1, none in its depthwise conv; SiLU of the sum in RepVGGDW; the CIB residual only
    when shortcut and c1 == c2; the head counts of v10m's and v10x's PSA."""
    sc = TM.SCDown(8, 16, 3, 2)
    assert (sc.cv1.act, sc.cv2.act, sc.cv2.conv.groups, sc.cv2.conv.stride) == ("mish", False, 16, (2, 2))
    rep = TM.RepVGGDW(8)
    assert (rep.conv.act, rep.conv1.act, rep.conv.conv.kernel_size, rep.conv1.conv.kernel_size) == \
        (False, False, (7, 7), (3, 3))
    assert TM.CIB(8, 8, True).add and not TM.CIB(8, 8, False).add and not TM.CIB(8, 16, True).add
    assert isinstance(TM.CIB(8, 8, lk=True).cv1[2], TM.RepVGGDW) and TM.CIB(8, 8).cv1[2].act == "mish"
    assert all(m.act == "mish" for m in TM.C2fCIB(8, 16, 1).modules() if isinstance(m, TM.ConvBN))
    for c1, heads, hd in ((576, 4, 72), (640, 5, 64)):
        attn = TM.PSA(c1, c1).attn
        assert (attn.nh, attn.hd) == (heads, hd)


@pytest.mark.parametrize("mode", ["eval", "folded", "train"])
@pytest.mark.parametrize("name,make,shape", BLOCKS, ids=IDS)
def test_block_matches_jax(name, make, shape, mode):
    """Outputs atol 1e-5 in eval mode, after `fuse_conv_bn` and in train mode; in train mode also the new BN
    running statistics (rtol/atol 1e-5), and in eval mode the statistics stay."""
    jmod, tmod = make()
    x = _x(shape)
    variables = seeded(jmod, shape)
    tmod.load_state_dict(flax_to_state_dict(variables), strict=True)
    if mode == "train":
        ref, mut = jmod.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        got = _nhwc(tmod.train()(_nchw(x)))
        stats = {k: b for k, b in tmod.named_buffers() if k.endswith(("running_mean", "running_var"))}
        new = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
        new = {k: v for k, v in new.items() if not k.endswith("num_batches_tracked")}
        assert stats.keys() == new.keys()
        for k, t in stats.items():
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        ref = jmod.apply(variables, jnp.asarray(x), training=False)
        tmod.eval()
        if mode == "folded":
            fuse_conv_bn(tmod, torch.float32)
        with torch.no_grad():
            got = _nhwc(tmod(_nchw(x)))
        before = flax_to_state_dict(variables)
        assert all(torch.equal(b, before[k]) for k, b in tmod.named_buffers() if "running" in k)
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


def _port_grads(make, variables, x, r, dtype):
    tmod = make()[1]
    tmod.load_state_dict(flax_to_state_dict(variables))
    tmod = tmod.to(dtype).train()
    xt = _nchw(x).to(dtype).requires_grad_()
    (tmod(xt) * _nchw(r).to(dtype)).sum().backward()
    grads = {k: p.grad.double() for k, p in tmod.named_parameters()}
    grads["input"] = xt.grad.permute(0, 2, 3, 1).double()
    return grads


@pytest.mark.parametrize("name,make,shape", BLOCKS, ids=IDS)
def test_block_gradients_match_jax(name, make, shape):
    """Train-mode gradients of sum(out * r) for the input and every parameter: `torch.autograd` in f32 and
    `jax.grad` each within 1e-4 of each leaf's largest value (floor 1e-5) of the port run in f64."""
    jmod = make()[0]
    x = _x(shape)
    variables = seeded(jmod, shape)
    out = jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])[0])
    r = _x(out.shape, seed=2)

    def loss(params, xx):
        y, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, training=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    ref = _port_grads(make, variables, x, r, torch.float64)
    got = _port_grads(make, variables, x, r, torch.float32)
    jgrads = {k: v.double() for k, v in flax_to_state_dict({"params": jax.tree.map(np.asarray, gp)}).items()}
    jgrads["input"] = torch.from_numpy(np.array(gx)).double()
    assert got.keys() == ref.keys() == jgrads.keys()
    for k, r64 in ref.items():
        atol = 1e-4 * float(r64.abs().max()) + 1e-5
        torch.testing.assert_close(got[k], r64, rtol=0, atol=atol, msg=lambda m: f"port f32 {k}: {m}")
        torch.testing.assert_close(jgrads[k], r64, rtol=0, atol=atol, msg=lambda m: f"JAX {k}: {m}")


# -- the graphs ----------------------------------------------------------------------------------


def jax_shapes(jm):
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))


def kernel_sites(tm) -> int:
    """The ConvBNs that take the conv3x3 kernel on the one2one serving path."""
    head = tm.model[-1]
    skip = {id(m) for tower in (head.cv2, head.cv3) for m in tower.modules()}  # the one2many branch
    return sum(isinstance(m, TM.ConvBN) and m.kernel_path and id(m) not in skip for m in tm.modules())


@pytest.mark.parametrize("scale", list(PARAMS))
def test_scale_graph_matches_jax(scale):
    """The port's layer specs and save list equal the JAX `parse_model`'s; the parameter count is the JAX
    package's; the port's variable shapes equal the JAX ones, bridged weights load with strict=True and go back
    to the JAX tree bit for bit. No layer is dead, strides are 8/16/32, and the conv3x3 kernel takes two
    convs per C2f bottleneck and the six one2one box-tower convs (a CIB has no 3x3 groups-1 conv)."""
    name = f"yolov10{scale}.yaml"
    assert (PORT_CFG / name).read_bytes() == (JAX_CFG / name).read_bytes()
    specs, save = TC.parse_model(TC.yaml_model_load(PORT_CFG / name))
    jspecs, jsave = JC.parse_model(JC.yaml_model_load(JAX_CFG / name))
    assert [dataclasses.astuple(s) for s in specs] == [dataclasses.astuple(s) for s in jspecs] and save == jsave
    yolo = YOLO(name, device="cpu", seed=None)
    tm = yolo.model
    assert sum(p.numel() for p in tm.parameters()) == PARAMS[scale]
    assert tm.strides == (8.0, 16.0, 32.0) and not tm.dead
    bottlenecks = sum(s.args[2] for s in specs if s.module == "C2f")
    assert kernel_sites(tm) == 2 * bottlenecks + 6
    jm = jax_build(JAX_CFG / name)
    shapes = jax_shapes(jm)
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


@pytest.mark.parametrize("scale", ["n", "m"])
def test_detections_match_jax(scale):
    """Full width, imgsz 64, batch 2, f32: the port's (B, 300, 6) against the JAX eval-mode `det`, and the
    serving fold's (3x3 s1 convs through conv3x3's plain version) as well; tie-tolerant, box 1e-3, score 1e-6."""
    name = f"yolov10{scale}.yaml"
    jm = jax_build(JAX_CFG / name)
    variables = random_variables(jax_shapes(jm), seed=0)
    x = np.random.default_rng(3).random((2, S, S, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jm.apply(v, t, training=False, predict_only=True)["det"])(variables, x))
    tm = load_flax(build_model(PORT_CFG / name, device="cpu"), variables)
    with torch.no_grad():
        got = tm.predict(_nchw(x)).numpy()
        folded = fuse_conv_bn(tm, torch.float32).predict(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 300, 6) and np.isfinite(got).all()
    for i in range(2):
        assert_detections_close(got[i], ref[i], atol_box=1e-3, atol_score=1e-6)
        assert_detections_close(folded[i], ref[i], atol_box=1e-3, atol_score=1e-6)


# -- yolov10n through the entry points -------------------------------------------------------------


@pytest.fixture(scope="module")
def v10n():
    """yolov10n at full width: the JAX model and its seeded variables."""
    jm = jax_build(JAX_CFG / "yolov10n.yaml")
    return jm, random_variables(jax_shapes(jm), seed=0)


@pytest.fixture
def jax_facade(v10n, monkeypatch):
    """The JAX `YOLO` class with its `_jit_init` replaced by the shared variables (no init compile)."""
    import lpc_yolo_tpu.engine.model as jax_model

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: v10n[1])
    return jax_model.YOLO


def frames(seed=11):
    """Frames that need no resize at imgsz 64 (r = 1), so both letterboxes give byte-equal feeds."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (48, 64, 3))]


def test_predict_matches_jax_pipeline(v10n, jax_facade):
    """YOLO("yolov10n.yaml").predict against the JAX facade's `YOLO.predict` on the same weights, imgsz 64,
    conf 0: scores within 1e-6 (tie-tolerant), boxes within 1e-3."""
    im = frames()
    ref = jax_facade("yolov10n.yaml").predict(im, imgsz=S, conf=0.0, batch=2)
    results = YOLO("yolov10n.yaml", device="cpu", seed=None).load_flax(v10n[1]).predict(
        im, device="cpu", imgsz=S, conf=0.0, batch=2)
    assert len(results) == len(ref) == 2
    for r, j, f in zip(results, ref, im):
        assert r.orig_shape == f.shape[:2] and len(r) > 0
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-6)


def test_yolo_save_loads_in_both_packages(v10n, jax_facade, tmp_path):
    """The port's `YOLO.save` -> the JAX `YOLO(path)`: the same variables bit for bit and detections within
    1e-6; that model's `save` -> the port's `YOLO(path)`: the same weights, the port's detections unchanged."""
    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    yolo = YOLO("yolov10n.yaml", device="cpu", seed=5, nc=3)
    yolo.names = {0: "red", 1: "green", 2: "blue"}
    jy = jax_facade(yolo.save(tmp_path / "port.ckpt"))
    assert (jy.model.nc, jy.task, jy.names) == (3, "v10", yolo.names)
    ref, got = jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict())
    for col in ("params", "batch_stats"):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got[col]),
                                    jax.tree_util.tree_leaves_with_path(ref[col])):
            assert pa == pb and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    im = frames(12)
    ours = yolo.predict(im, imgsz=S, conf=0.0, batch=2, device="cpu")
    for r, j in zip(ours, jy.predict(im, imgsz=S, conf=0.0, batch=2)):
        assert len(r) > 0
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-6)
    back = YOLO(jy.save(str(tmp_path / "jax.ckpt")), device="cpu")
    assert (back.model.nc, back.names) == (3, yolo.names)
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for r, o in zip(back.predict(im, imgsz=S, conf=0.0, batch=2, device="cpu"), ours):
        np.testing.assert_array_equal(r.boxes.data, o.boxes.data)


def write_dataset(root: Path, jm, variables) -> Path:
    """Six noise PNGs no larger than imgsz (the validator's scaleup=False only pads them, so both
    letterboxes give byte-equal feeds), one without a label file; the labels are the JAX model's own
    strongest, mutually non-overlapping detections (as `tests/test_torch_val.py` makes them)."""
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(7)
    predict = jax.jit(lambda v, x: jm.apply(v, x, training=False, predict_only=True)["det"])
    for i, (h0, w0) in enumerate(((48, 40), (64, 64), (50, 64), (32, 56), (64, 30), (40, 40))):
        img = rng.integers(0, 256, (h0, w0, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "images" / "val" / f"{i}.png"), img)
        if i == 4:
            continue
        lb, gain, (pw, ph) = letterbox_image(img, (S, S), scaleup=False)
        assert gain == 1.0
        det = np.asarray(predict(variables, jnp.asarray(lb[None, ..., ::-1].astype(np.float32) / 255)))[0]
        keep = []
        for row in det:
            b = row[:4].astype(np.float64)
            if min(b[2] - b[0], b[3] - b[1]) < 4:
                continue
            if keep and box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, int(row[5])))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = b - [pw, ph, pw, ph]
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(lines) + "\n")
    (root / "data.yaml").write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "nc": 80}))
    return root / "data.yaml"


def test_val_matches_jax(v10n, jax_facade, tmp_path):
    """YOLO("yolov10n.yaml").val(data=...) agrees with the JAX YOLO.val's results dict
    (`assert_val_results_agree`: mAP keys and fitness to the last digit)."""
    data = write_dataset(tmp_path, *v10n)
    ref = jax_facade("yolov10n.yaml").val(data=str(data), imgsz=S, batch=4, workers=2)
    got = YOLO("yolov10n.yaml", device="cpu", seed=None).load_flax(v10n[1]).val(
        data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.3  # the labels are the JAX model's own detections
    assert_val_results_agree(got, ref)


# -- one train step on a narrow yolov10n -------------------------------------------------------------


def narrow_yaml() -> dict:
    d = yaml.safe_load((PORT_CFG / "yolov10n.yaml").read_text())
    d.update(nc=4, scales={"t": [0.1, 0.0625, 512]}, scale="t")
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
    """The port's loss on `batch` and the clipped gradient (+ weight_decay * p on kernels) that one update
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
    """Loss and items rtol 1e-4; the first momentum trace of the JAX step within 1e-2 of each leaf's largest
    value of the port run in f64, and the two f32 traces within 1e-2 of each other (floor 1e-5): the
    tolerances of `tests/test_torch_train.py`, whose docstring says why. The port's f32 trace is held to the
    f64 run within 2e-3, not that file's 5e-4: on this graph its worst leaf, `model.2.m.0.cv1.bn.weight`
    (four channels, each a sum of 512 terms that nearly cancel), is 8.2e-4 off with one torch thread and
    1.6e-4 with eight, which changes only the summation order, and the JAX step's is 1.0e-3 off."""
    d = narrow_yaml()
    jm = jax_build(d)
    variables = random_variables(jax_shapes(jm), seed=0)
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v10").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    total, items, t32 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float32, tcfg)
    _, _, t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64, tcfg)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)
    assert_named_close(t32, ref, 1e-2, "trace of", floor=1e-5)
