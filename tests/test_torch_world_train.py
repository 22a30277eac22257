"""YOLO-World training of the port against the JAX package, on the CPU: the train step with the names' text and with
zero text, `train(data=...)` with a resume, and the two JAX faults the port does not copy.

A narrow yolov8-world (scale [0.33, 0.125, 1024], every layer kept: ImagePoolingAttn, four C2fAttn, WorldDetect
with ContrastiveHead), nc 3, 64 px, batch 2; weights from `random_variables` through the weight bridge. The JAX
side is jitted with XLA's fusion pass off. Tolerances:

* With the names' text (`encode_names` of three names, (1, 3, 512) broadcast to the batch): the port's loss and its
  3 items (box, cls, dfl) within 1e-4 relative of `jax.value_and_grad` of the JAX v8 loss on `apply(text=...,
  training=True)`; the gradients held to the port's f64 run, the port's f32 ones within 1e-3 (6.0e-4 measured, at a
  C2fAttn's attention bias) and JAX's within 2e-3 (1.5e-3) of each leaf's largest value, floor 1e-7 (the
  ImagePoolingAttn's key biases have none: a constant added to every key leaves the softmax as it is), as
  `tests/test_torch_v8.py` holds the v8 step's (batch statistics at batch 2, and JAX's CPU BatchNorm drifts:
  ROADMAP Queue 3); every `cv3_*` leaf gets a gradient.
* With zero text (the port's `make_train_step(..., text=None)`, what the JAX step gives a World graph): the loss
  and items within 1e-4 relative of the JAX package's own `make_train_step(loss_kind="v8")`, and the first momentum
  trace within the tolerances `tests/test_torch_v8.py` holds the v8 step to.
* The JAX faults (the JAX package stays as it is): its train step passes no text (`engine/train_step.py:198-204`),
  so the graph takes zero text and every `cv3_*` leaf's gradient is exactly 0 (its trace holds the weight decay
  alone); its validator passes none either (`engine/validator.py:99`), so every class of an anchor scores alike,
  whatever `set_classes` set.
* `YOLO(<narrow world>, nc=3).train(data=...)`: the facade's names and text become the dataset's; 2 epochs of 2 steps,
  results.csv with train/box, train/cls and train/dfl; a run stopped in epoch 2 and resumed equals the uninterrupted
  one bit for bit.
"""

import signal

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.losses.detection import v8_detection_loss as jax_v8_loss

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_shapes, flax_to_state_dict, is_flax_kernel, load_flax,
                                                  random_variables, train_state_dict)
from lpc_yolo_tpu_torch.utils.text_embed import encode_names
from test_torch_ckpt import assert_trees_equal
from test_torch_v8 import XLA_OPTS, assert_named_close, make_batch
from test_torch_world import S, jax_world, narrow

NAMES = ["red", "green", "blue"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    """The narrow yolov8-world at nc 3, its seeded variables, the JAX graph and a batch (f32 RGB in [0, 1])."""
    from test_torch_zoo import jax_graph

    d = narrow("v8/yolov8-world.yaml", nc=3)
    tm = build_model(d, device="cpu")
    variables = random_variables(flax_shapes(tm), seed=3)
    batch = make_batch(0)
    batch["cls"] = batch["cls"] % 3
    return {"d": d, "variables": variables, "jm": jax_graph(d, tm.strides), "batch": batch}


def port_grads(world, dtype, text):
    """The port's v8 loss (through `make_loss_fn`) of the batch, its items and the gradient of every parameter."""
    tm = load_flax(build_model(world["d"], device="cpu"), world["variables"]).to(dtype).train()
    batch = tts.to_device(world["batch"], torch.device("cpu"))
    batch["img"] = batch["img"].to(dtype)
    total, items = tts.make_loss_fn(tm, text=text)(batch)
    total.backward()
    return total.detach(), items, {k: p.grad for k, p in tm.named_parameters()}


def test_train_step_with_text_matches_jax(world):
    """The loss, its items and the gradients with the names' text against `jax.value_and_grad` of the JAX v8 loss on
    the graph's `apply(text=..., training=True)` (see the module docstring for the tolerances)."""
    jm, variables, batch = world["jm"], world["variables"], world["batch"]
    table = encode_names(NAMES)[None]
    text = jnp.asarray(np.broadcast_to(table, (2, 3, 512)))

    def loss(params, x):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, training=True,
                          text=text, mutable=["batch_stats"])
        total, items = jax_v8_loss(out, batch["cls"], batch["bboxes"], batch["mask"], jm.strides, 3)
        return total, jnp.stack(list(items))

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (jtotal, jitems), jgrads = fn.lower(variables["params"], batch["img"]).compile(compiler_options=XLA_OPTS)(
        variables["params"], batch["img"])
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jgrads)})
    total, items, g32 = port_grads(world, torch.float32, table)
    _, _, g64 = port_grads(world, torch.float64, table)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=1e-4)
    assert_named_close(g32, g64, 1e-3, "f32 gradient against f64 of", floor=1e-7)
    assert_named_close(ref, g64, 2e-3, "JAX gradient against the port's f64 of", floor=1e-7)
    cv3 = [k for k in g32 if ".cv3." in k]
    assert len(cv3) == 3 * 8 and all(g32[k].abs().max() > 0 for k in cv3)


def jax_first_step(world):
    """The JAX package's own train step (loss_kind "v8", as its trainer routes a World model) from zero momentum."""
    jm, variables = world["jm"], world["variables"]
    jcfg = jts.OptConfig(warmup_steps=2, total_steps=10)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    raw = jts.make_train_step(jm, tx, jcfg, loss_kind="v8").__wrapped__
    jstep = jax.jit(raw).lower(jstate, world["batch"]).compile(compiler_options=XLA_OPTS)
    jstate, jmet = jstep(jstate, world["batch"])
    trace = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.opt_state[2].inner_state.trace)})
    return jmet, trace, jcfg


@pytest.fixture(scope="module")
def jax_step(world):
    return jax_first_step(world)


def test_zero_text_step_matches_jax_make_train_step(world, jax_step):
    """The port's step given no text (zeros of (B, nc, 512)) against the JAX package's `make_train_step`: the loss
    and items within 1e-4 relative, and the first momentum trace (the clipped gradient plus the weight decay of the
    `kernel` leaves) held as `tests/test_torch_v8.py` holds the v8 step's: the JAX trace within 1e-2 of each leaf's
    largest value of the port's f64 trace, the port's f32 trace within 2e-3 of it, the two f32 traces within 1e-2
    of each other (floor 1e-5). Then two of the port's own steps move the parameters."""
    jmet, ref, jcfg = jax_step
    tcfg = tts.OptConfig(warmup_steps=2, total_steps=10)
    traces, mets = {}, {}
    for dtype in (torch.float32, torch.float64):
        total, items, grads = port_grads(world, dtype, None)
        named = dict(load_flax(build_model(world["d"], device="cpu"), world["variables"]).to(dtype).named_parameters())
        gnorm = tts.global_norm(list(grads.values()))
        scale = tcfg.grad_clip / gnorm.clamp(min=tcfg.grad_clip)
        traces[dtype] = {k: g * scale + (tcfg.weight_decay * named[k].detach() if is_flax_kernel(k, g.dim()) else 0)
                         for k, g in grads.items()}
        mets[dtype] = (total, items)
    np.testing.assert_allclose(float(mets[torch.float32][0]), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(mets[torch.float32][1].numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    t32, t64 = traces[torch.float32], traces[torch.float64]
    assert_named_close(t32, t64, 2e-3, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)
    assert_named_close(t32, ref, 1e-2, "trace of", floor=1e-5)

    tm = load_flax(build_model(world["d"], device="cpu"), world["variables"])
    state = tts.init_train_state(tm, tcfg, device="cpu")
    step = tts.make_train_step(tm, tcfg, loss_kind="world")
    start = {k: v.detach().clone() for k, v in state.params.items()}
    for i in range(2):
        state, met = step(state, {**make_batch(i), "cls": make_batch(i)["cls"] % 3})
        assert met["items"].shape == (3,) and met["skipped"] is False
    assert any(not torch.equal(v, start[k]) for k, v in state.params.items())
    with pytest.raises(ValueError, match="task .world."):
        tts.make_train_step(tm, tcfg, loss_kind="v8")


def test_jax_train_step_gives_the_class_towers_no_gradient(world, jax_step):
    """The JAX fault: the JAX train step runs a World graph on zero text, whose contrastive logits are the head's
    bias alone, so every `cv3_*` leaf (the embedding towers) gets a gradient of exactly 0: the first momentum trace
    of a bias is 0 and of a kernel the weight decay alone. The port's step with the names' text gives them one
    (`test_train_step_with_text_matches_jax`)."""
    _, trace, jcfg = jax_step
    params = flax_to_state_dict({"params": world["variables"]["params"]})
    cv3 = [k for k in trace if ".cv3." in k]
    assert len(cv3) == 3 * 8
    for k in cv3:
        decay = jcfg.weight_decay * params[k] if is_flax_kernel(k, params[k].dim()) else torch.zeros_like(params[k])
        np.testing.assert_allclose(trace[k].numpy(), decay.numpy(), rtol=1e-6, atol=0, err_msg=k)
    assert any(trace[k].abs().max() > 0 for k in trace if ".cv2." in k)


def test_jax_validator_scores_every_class_alike(world, monkeypatch, tmp_path):
    """The JAX fault: the JAX validator's predict passes no text, so whatever `set_classes` set, every class of an
    anchor scores alike: its rows come in threes (one a class) of the same box and score. The port's validator
    reads the facade's table, and its class scores differ."""
    from lpc_yolo_tpu.engine.validator import Validator as JaxValidator

    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.engine.validator import Validator

    cfg = tmp_path / "yolov8n-world-narrow.yaml"
    cfg.write_text(yaml.safe_dump(world["d"]))
    jy = jax_world(monkeypatch, cfg, world["variables"], nc=3)
    jy.set_classes(NAMES)
    frames = np.random.default_rng(5).integers(0, 256, (2, S, S, 3), dtype=np.uint8)
    predict = JaxValidator(jy, imgsz=S)._make_predict(jy.model, jy.variables)
    det = np.asarray(predict(jy.variables, jnp.asarray(frames.reshape(2, S, S // 8, 24))))  # its packed BGR feed
    for rows in det:
        rows = rows[rows[:, 5] >= 0]
        assert len(rows) >= 30 and len(rows) % 3 == 0
        groups = rows[np.lexsort((rows[:, 5], rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))].reshape(-1, 3, 6)
        assert (groups[:, :, :5] == groups[:, :1, :5]).all() and (groups[:, :, 5] == [0, 1, 2]).all()
    yolo = YOLO(cfg, device="cpu", seed=None).load_flax(world["variables"]).set_classes(NAMES)
    v = Validator(yolo, imgsz=S, device="cpu")
    v.text = torch.from_numpy(yolo.txt_feats)
    det = v.predict(serving_model(yolo.model, torch.device("cpu"), torch.float32), torch.from_numpy(frames))
    rows = det[0][det[0][:, 5] >= 0]
    boxes = {tuple(r[:4]) for r in rows}
    assert len({tuple(r[:5]) for r in rows}) > len(boxes)  # the same box scores its classes apart


# -- training from a dataset ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_runs(tmp_path_factory, world):
    """`YOLO(<narrow world>, nc=3).train(data=...)` for 2 epochs of 2 steps (8 frames, batch 4, AdamW by the "auto"
    rule): once straight through, and once stopped (SIGTERM) in the first step of epoch 2 and resumed."""
    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    tmp = tmp_path_factory.mktemp("world_train")
    cfg = tmp / "yolov8n-world-narrow.yaml"
    cfg.write_text(yaml.safe_dump(world["d"]))
    data = make_synthetic_dataset(tmp / "data", n_train=8, n_val=4, imgsz=S, nc=3, max_boxes=4, seed=2)
    kw = dict(data=data, imgsz=S, batch=4, epochs=2, close_mosaic=1, workers=2, device="cpu")
    out = {"tmp": tmp, "data": data}
    out["straight"] = YOLO(cfg, device="cpu", seed=0, nc=3)
    out["straight_results"] = out["straight"].train(save_dir=tmp / "straight", **kw)
    real_render, calls = port_trainer.render, []

    def stopping_render(plans, sources, device):
        calls.append(1)
        if len(calls) == 3:  # epoch 2, step 1: the step finishes, then the run stops
            signal.raise_signal(signal.SIGTERM)
        return real_render(plans, sources, device)

    try:
        port_trainer.render = stopping_render
        YOLO(cfg, device="cpu", seed=0, nc=3).train(save_dir=tmp / "stopped", **kw)
    finally:
        port_trainer.render = real_render
    out["resumed"] = YOLO(cfg, device="cpu", seed=0, nc=3)
    out["resumed"].train(save_dir=tmp / "stopped", resume=True, **kw)
    return out


def test_train_from_data_on_the_cpu(data_runs):
    """The straight run: the facade's names and text table become the dataset's (in index order) before the first
    step; 4 steps, none skipped, every loss finite; results.csv has one row an epoch with train/box, train/cls and
    train/dfl and the validator's keys; last.ckpt and best.ckpt; the facade then holds the EMA weights and predicts
    the dataset's classes."""
    from lpc_yolo_tpu_torch.data import check_det_dataset

    yolo = data_runs["straight"]
    names = check_det_dataset(data_runs["data"])["names"]
    assert yolo.names == names and yolo.task == "world"
    np.testing.assert_array_equal(yolo.txt_feats, encode_names([names[i] for i in range(3)])[None])
    tr = yolo.trainer
    assert len(tr.history) == 4 and not any(h["skipped"] for h in tr.history)
    assert all(np.isfinite(h["loss"]) and len(h["items"]) == 3 for h in tr.history)
    rows = (data_runs["tmp"] / "straight" / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].split(",")[:4] == ["epoch", "train/box", "train/cls", "train/dfl"]
    assert np.isfinite(list(data_runs["straight_results"].values())).all()
    assert sorted(p.name for p in (data_runs["tmp"] / "straight" / "weights").iterdir()) == ["best.ckpt",
                                                                                             "last.ckpt"]
    for k, v in tr.state.ema_params.items():
        assert torch.equal(yolo.model.state_dict()[k], v)
    frame = np.random.default_rng(3).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    res = yolo.predict([frame], imgsz=S, conf=0.0, device="cpu")
    assert len(res[0]) > 0 and set(res[0].boxes.data[:, 5].tolist()) <= {0.0, 1.0, 2.0}


def test_resumed_run_equals_the_uninterrupted_run(data_runs):
    """Stopped in epoch 2 and resumed from last.ckpt (epoch 1), the run ends in the uninterrupted run's state bit
    for bit (parameters, the contrastive heads' `bias` and `logit_scale`, BN statistics, AdamW's two moments, the
    EMA), through the `.ckpt` tree."""
    ref, resumed = data_runs["straight"].trainer, data_runs["resumed"].trainer
    assert resumed.start_epoch == 1 and [h["epoch"] for h in resumed.history] == [1, 1]
    assert (resumed.state.step, resumed.state.opt_step) == (ref.state.step, ref.state.opt_step) == (4, 4)
    assert ref.cfg.optimizer == "adamw"
    assert_trees_equal(train_state_dict(resumed.state, resumed.cfg), train_state_dict(ref.state, ref.cfg))
    assert [h["items"] for h in resumed.history] == [h["items"] for h in ref.history[2:]]
