"""The other CNN detection YAMLs of the port, trained and validated against the JAX package on the CPU in f32
(`tests/test_torch_zoo.py` holds their graphs and forwards).

* The v8 loss over v3-tiny's 2 levels and P2's and P6's 4, the seg and pose losses
  over P6's 4 (the anchors, the TAL assigner and every term), against the JAX
  losses: rtol 1e-5 / atol 1e-6, gradients against the port's f64 run.
* One v8 train step of a narrow yolov8-p2 (4 levels) against the JAX step: the
  loss and items of each within rtol 2e-5 of the port's f64 run, the momentum
  trace at the tolerances of `tests/test_torch_v8.py`.
* `val(data=...)` of yolov8n-p6 and yolov3-tiny at full width, imgsz 64, through
  `assert_val_results_agree`, with the box towers' last bias lowered as in
  `tests/test_torch_v8.py` so the boxes fit the 64-px frames.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.losses.detection import v8_detection_loss as jax_v8_loss
from lpc_yolo_tpu.losses.pose import v8_pose_loss as jax_pose_loss
from lpc_yolo_tpu.losses.segment import v8_segmentation_loss as jax_seg_loss

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.losses import v8_detection_loss, v8_pose_loss, v8_segmentation_loss
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils.compare import assert_val_results_agree
from lpc_yolo_tpu_torch.utils.flax_bridge import flax_shapes, flax_to_state_dict, load_flax, random_variables
from test_torch_v8 import XLA_OPTS, assert_named_close, make_batch, port_first_trace, small_boxes, write_dataset
from test_torch_zoo import JAX_CFG, P2_5, S, ZOO, jax_graph, narrow


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models are small at imgsz 64: beside a test run's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the losses over 2 and 4 levels ---------------------------------------------------------------------------------

LEVELS = {"v3-tiny": (16.0, 32.0), "p2": (4.0, 8.0, 16.0, 32.0), "p6": (8.0, 16.0, 32.0, 64.0)}


@pytest.mark.parametrize("kind,levels", [("v8", "v3-tiny"), ("v8", "p2"), ("v8", "p6"), ("seg", "p6"), ("pose", "p6")])
def test_loss_over_levels_matches_jax(kind, levels):
    """The v8, seg and pose losses (the anchors, the TAL assigner, the box, DFL, class, mask and keypoint terms)
    over the level sets these YAMLs add: v3-tiny's 2 (strides 16, 32), P2's 4 (4 to 32), P6's 4 (8 to 64), at
    128 px (P6's last level 2x2), nc 5, batch 2 with 5 and 9 of 16 gts: total and items rtol 1e-5 / atol 1e-6
    against the JAX loss, the port's f32 gradients within 1e-4 of each one's largest of its f64 run (the
    tolerances of `tests/test_torch_seg.py` and `tests/test_torch_pose_data.py`)."""
    strides, size, nc, M = LEVELS[levels], 128, 5, 16
    rng = np.random.default_rng(7)
    shapes = [(size // int(s), size // int(s)) for s in strides]
    maps = [rng.standard_normal((2, h, w, 64 + nc)).astype(np.float32) for h, w in shapes]
    A = sum(h * w for h, w in shapes)
    xy = rng.uniform(0, size * 0.6, (2, M, 2))
    mask = np.arange(M)[None] < np.array([[5], [9]])
    gt = (np.concatenate([xy, xy + rng.uniform(6, size * 0.4, (2, M, 2))], -1) * mask[..., None]).astype(np.float32)
    lab = rng.integers(0, nc, (2, M)).astype(np.int32)
    extra = {"seg": {"mc": rng.standard_normal((2, A, 32)), "proto": rng.standard_normal((2, size // 4, size // 4, 32))},
             "pose": {"kpt_raw": rng.standard_normal((2, A, 51))}}.get(kind, {})
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    gts = [lab, gt, mask]
    if kind == "seg":
        gts.append((rng.random((2, M, size // 4, size // 4)) < 0.4).astype(np.uint8))
    if kind == "pose":
        kxy = gt[..., None, :2] + rng.uniform(0, 1, (2, M, 17, 2)) * (gt[..., None, 2:] - gt[..., None, :2])
        gts.append(np.concatenate([kxy, rng.integers(0, 3, (2, M, 17, 1))], -1).astype(np.float32))
    jfeats = tuple(jnp.asarray(m) for m in maps)
    jgts = [jnp.asarray(g) for g in gts]
    if kind == "v8":
        ref_total, ref_items = jax.jit(lambda f, *g: jax_v8_loss(f, *g, strides, nc))(jfeats, *jgts)
    else:
        jout = {"feats": jfeats, **{k: jnp.asarray(v) for k, v in extra.items()}}
        loss = jax_seg_loss if kind == "seg" else jax_pose_loss
        ref_total, ref_items = jax.jit(lambda o, *g: loss(o, *g, strides, nc))(jout, *jgts)

    def port(dtype):
        leaves = [torch.from_numpy(m.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_() for m in maps]
        more = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy() if k == "proto" else v).to(dtype).requires_grad_()
                for k, v in extra.items()}
        feats = [(t[:, :64], t[:, 64:]) for t in leaves]
        tgts = [torch.from_numpy(g) for g in gts]
        if kind == "v8":
            total, items = v8_detection_loss(feats, *tgts, strides, nc)
        else:
            total, items = (v8_segmentation_loss if kind == "seg" else v8_pose_loss)({"feats": feats, **more}, *tgts,
                                                                                     strides, nc)
        total.backward()
        return total, items, [t.grad for t in leaves + list(more.values())]

    total, items, g32 = port(torch.float32)
    g64 = port(torch.float64)[2]
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5, atol=1e-6)
    items, ref_items = (np.stack([np.asarray(t) for t in i]) for i in (items, ref_items))  # v8's are LossItems
    np.testing.assert_allclose(items, ref_items, rtol=1e-5, atol=1e-6)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=0, atol=1e-4 * float(b.abs().max()))


# -- training a narrow yolov8-p2 ------------------------------------------------------------------------------------


def test_p2_train_step_matches_jax():
    """The v8 loss over four levels (strides 4 to 32; the top-10 assigner over 340 anchors at 64 px) through the
    JAX step (loss_kind "v8") and the port's on a narrow yolov8-p2 (nc 4, batch 2): the loss and its items of
    each within rtol 2e-5 of the port's f64 run, and the two f32 losses within rtol 3e-5 of each other (the cls
    item, ~735, sums the BCE of 340 anchors x 4 classes over a target-score sum near 1, so f32 summation order
    alone moves it by up to ~1.4e-5 relative: measured 1.35e-5 between the two, each within 1.1e-5 of f64);
    the first momentum trace of the JAX step within 1e-2 of each leaf's largest value of the port's f64 run, the
    port's f32 trace within 2e-3 of it (floor 1e-5), the tolerances of `tests/test_torch_v8.py`."""
    d = narrow("v8/yolov8-p2.yaml", nc=4)
    tm = build_model(d, device="cpu")
    assert tm.strides == P2_5
    variables = random_variables(flax_shapes(tm), seed=0)
    jm = jax_graph(d, tm.strides)
    jcfg, tcfg = jts.OptConfig(warmup_steps=2, total_steps=10), tts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch = make_batch(0)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v8").__wrapped__
    jstep = jax.jit(raw).lower(jstate, batch).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, batch)
    total, items, t32 = port_first_trace(load_flax(tm, variables), batch, torch.float32, tcfg)
    loss64, items64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64,
                                       tcfg)[:2]
    for loss, parts in ((float(total), items.numpy()), (float(jmet["loss"]), np.asarray(jmet["items"]))):
        np.testing.assert_allclose(loss, float(loss64), rtol=2e-5)
        np.testing.assert_allclose(parts, items64.numpy(), rtol=2e-5)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=3e-5)
    t64 = port_first_trace(load_flax(build_model(d, device="cpu"), variables), batch, torch.float64, tcfg)[2]
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)


# -- val of a P6 and of v3-tiny -------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolov8n-p6.yaml", "yolov3-tiny.yaml"])
def test_val_matches_jax(name, tmp_path, monkeypatch):
    """`YOLO(<name>).val(data=...)` at full width (conf 0.001, iou 0.7, multi-label NMS, imgsz 64) against the JAX
    facade's `val` on the same weights (with small boxes) and data: `assert_val_results_agree`. yolov8n-p6 reads
    four levels (the 1x1 P6 map at 64 px), yolov3-tiny two."""
    import lpc_yolo_tpu.engine.model as jax_model

    cfg = ZOO[name][0]
    yolo = YOLO(name, device="cpu", seed=None)
    jm = jax_graph(yolo.model_yaml, yolo.model.strides)
    variables = small_boxes(random_variables(flax_shapes(yolo.model), seed=0), head=f"model_{len(jm.specs) - 1}")
    yolo.load_flax(variables)
    data = write_dataset(tmp_path, jm, variables)
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: variables)
    jy = jax_model.YOLO(name if cfg.startswith("v8/") else str(JAX_CFG / cfg))  # the JAX resolver has no v3 folder
    ref = jy.val(data=str(data), imgsz=S, batch=4, workers=2)
    got = yolo.val(data=str(data), imgsz=S, batch=4, workers=2)
    assert ref["metrics/mAP50(B)"] > 0.3  # the labels are the JAX model's own detections
    assert_val_results_agree(got, ref)
