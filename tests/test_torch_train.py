"""The training slice of the port against the JAX package, on the CPU in f32.

The model is the LPC-YOLO YAML's own layer list (every block type of the
slice) at small channel counts: widths 8-32, one bottleneck per C2f, nc 4,
imgsz 64, batch 2, 4 padded gts. The JAX train step is compiled once per
module, with XLA's fusion pass off: with it the step's compile on a CPU
takes minutes, without it well under one; the arithmetic is the same f32.
It is compiled for f32 RGB images, so where the port is fed uint8 BGR frames
the JAX step gets `u8.astype(f32)[..., ::-1] / 255`, which is what its own
uint8 branch computes (`train_step.py:176`).

Tolerances. The JAX package's f32 BatchNorm statistics on a CPU are noisier
than torch's: XLA sums the batch serially and flax takes the variance as
E[x^2] - E[x]^2, so already the stem's variance is off by 3e-5 relative, and
the train-mode head maps (values up to ~5) end 4.9e-4 from the port run in
f64, while the port's f32 maps are within 2.4e-5 of it. The maps are therefore
held to atol 1e-3. Gradients inherit the noise: against the port run in f64,
the port's f32 gradients are within 1.4e-4 of each leaf's largest value and
the JAX package's within 4.8e-3, so the gradient test takes the f64 run as the
arbiter and holds both to it (on the clipped gradients that the first update
leaves in the momentum trace), and the momentum trace (clipped gradients) is
held to 1e-2 of each leaf's largest value after one step from the same state. Parameters and EMA after one step from the same state meet 2e-4
(the optimizer alone, on given gradients, agrees with optax to 2e-6), BN statistics atol 1e-5 after one forward and 5e-5 over the steps.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import build_model as jax_build

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import TrainTransforms, make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.trainer import Trainer, pack_img
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils.flax_bridge import (flax_to_state_dict, load_flax, random_variables,
                                                  train_state_from_flax, train_state_to_flax)

ROOT = Path(__file__).resolve().parents[1]
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
XLA_OPTS = {"xla_disable_hlo_passes": "fusion"}
B, S, M = 2, 64, 4
CFG = dict(warmup_steps=2, total_steps=10)


def narrow_yaml() -> dict:
    d = yaml.safe_load(PORT_YAML.read_text())
    d.update(nc=4, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    return d


def make_batch(seed: int) -> dict:
    """A loader-format batch: uint8 BGR frames, padded gts."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (B, M, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (B, M, 2))], -1).astype(np.float32)
    mask = np.array([[True, True, True, False], [True, False, False, False]])
    return {"img": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
            "cls": rng.integers(0, 4, (B, M)).astype(np.int32),
            "bboxes": boxes * mask[..., None], "mask": mask}


def as_f32(batch: dict) -> dict:
    """The batch with its frames as f32 RGB in [0, 1], the JAX step's uint8 branch done in numpy."""
    return {**batch, "img": batch["img"].astype(np.float32)[..., ::-1] / np.float32(255.0)}


def momentum_of(jstate):
    """The SGD trace inside the optax chain's state (a tree shaped like params)."""
    return jstate.opt_state[2].inner_state.trace


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    d = narrow_yaml()
    jm = jax_build(d)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    variables = random_variables(shapes, seed=0)
    jcfg = jts.OptConfig(**CFG)
    jstate, tx = jts.init_train_state(jm, variables, jcfg)
    batch0 = as_f32(make_batch(0))
    raw_step = jts.make_train_step(jm, tx, jcfg, loss_kind="v10").__wrapped__  # jitted here, undonated
    lowered = jax.jit(raw_step).lower(jstate, batch0)
    # XLA compiles outside the interpreter lock: the tests that need no JAX step run meanwhile, torch on one
    # thread (this model is tiny) so that the two do not fight over the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile, compiler_options=XLA_OPTS)
        yield {"yaml": d, "jm": jm, "variables": variables, "jstate": jstate, "jstep": compiling.result}
    torch.set_num_threads(threads)


def port_model(world):
    tm = build_model(world["yaml"], device="cpu")
    return load_flax(tm, world["variables"])


def assert_named_close(named, ref, tol, what, floor=0.0):
    """Two sets of state_dict-named tensors, within tol of each reference leaf's largest value (+ floor)."""
    assert named.keys() == ref.keys()
    for k, t in named.items():
        r = ref[k].detach().double().numpy()
        np.testing.assert_allclose(t.detach().double().numpy(), r, rtol=0, atol=tol * np.abs(r).max() + floor,
                                   err_msg=f"{what} {k}")


def assert_tree_close(named, tree, tol, what, floor=0.0):
    """State_dict-named tensors against a JAX params-shaped tree."""
    assert_named_close(named, flax_to_state_dict({"params": tree}), tol, what, floor)


def assert_stats_close(named, tree, atol, what):
    ref = flax_to_state_dict({"batch_stats": tree})
    ref = {k: v for k, v in ref.items() if not k.endswith("num_batches_tracked")}
    assert named.keys() == ref.keys()
    for k, t in named.items():
        np.testing.assert_allclose(t.numpy(), ref[k].numpy(), rtol=1e-5, atol=atol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def jax_forward(world):
    """The JAX train-mode forward on batch 0: both branches' maps and the new BN statistics."""
    jm, variables = world["jm"], world["variables"]
    batch = as_f32(make_batch(0))
    fn = jax.jit(lambda v, x: jm.apply(v, x, training=True, mutable=["batch_stats"]))
    out, mut = fn(variables, jnp.asarray(batch["img"]))
    return {"batch": batch, "out": out, "stats": mut["batch_stats"]}


def test_train_mode_forward_matches_jax(world, jax_forward):
    """(a) both branches' maps (atol 1e-3, see the module docstring) and the new BN running statistics
    (atol 1e-5)."""
    tm = port_model(world).train()
    x = torch.from_numpy(jax_forward["batch"]["img"])
    out = tm(x, input_layout="NHWC")
    assert set(out) == {"one2many", "one2one"}
    for name in out:
        for (box, cls), ref in zip(out[name], jax_forward["out"][name]):
            got = torch.cat([box, cls], 1).permute(0, 2, 3, 1).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-3)
    stats = {k: b for k, b in tm.named_buffers() if k.endswith(("running_mean", "running_var"))}
    assert_stats_close(stats, jax_forward["stats"], 1e-5, "BN statistic")
    # the layer nothing reads is computed in train mode: its statistics moved too
    before = flax_to_state_dict({"batch_stats": world["variables"]["batch_stats"]})
    assert not torch.equal(stats["model.27.cv1.bn.running_mean"], before["model.27.cv1.bn.running_mean"])
    # ... and not in eval mode, where the statistics stay
    em = port_model(world).eval()
    with torch.no_grad():
        em(x, input_layout="NHWC")
    assert torch.equal(em.state_dict()["model.27.cv1.bn.running_mean"], before["model.27.cv1.bn.running_mean"])


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 10, 25])
def test_schedules_match_jax(step):
    jcfg, tcfg = jts.OptConfig(**CFG), tts.OptConfig(**CFG)
    assert dataclasses.asdict(jts.OptConfig()) == dataclasses.asdict(tts.OptConfig())
    np.testing.assert_allclose(tts.lr_at(step, tcfg), float(jts.lr_at(jnp.asarray(step), jcfg)), rtol=1e-6)
    np.testing.assert_allclose(tts.momentum_at(step, tcfg), float(jts.momentum_at(jnp.asarray(step), jcfg)),
                               rtol=1e-6)
    np.testing.assert_allclose(tts.linear_lf(step, tcfg), float(jts.linear_lf(jnp.asarray(step), jcfg)), rtol=1e-6)


def optax_update(variables, jcfg):
    """The JAX package's optax chain for `jcfg` + its EMA formula, compiled as one update on given
    gradients, and the starting (params, opt_state, ema, count)."""
    import optax

    tx = jts.make_optimizer(variables["params"], jcfg)

    def update(grads, opt_state, params, ema, n):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        d = jcfg.ema_decay * (1.0 - jnp.exp(-(n + 1.0) / jcfg.ema_tau))
        return opt_state, params, jax.tree.map(lambda e, p: e * d + (1.0 - d) * p, ema, params), n + 1.0

    params, opt_state = variables["params"], tx.init(variables["params"])
    ema, n = variables["params"], jnp.zeros((), jnp.float32)
    update = jax.jit(update).lower(params, opt_state, params, ema, n).compile(compiler_options=XLA_OPTS)
    return update, params, opt_state, ema, n


def test_optimizer_and_ema_match_optax(world):
    """The update alone, on the same seeded gradients (no forward, so none of its noise): three updates of
    the optax chain + the JAX step's EMA formula against `apply_update`; params, momentum and EMA within 2e-6
    of each leaf's largest value. The first gradients are large (the clip acts), the last small (it does not)."""
    variables, jcfg, tcfg = world["variables"], jts.OptConfig(**CFG), tts.OptConfig(**CFG)
    update, params, opt_state, ema, n = optax_update(variables, jcfg)
    tstate = tts.init_train_state(port_model(world), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    for scale in (3.0, 1.0, 1e-3):
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)
        opt_state, params, ema, n = update(grads, opt_state, params, ema, n)
        named = flax_to_state_dict({"params": grads})
        tgrads = [named[k].clone() for k in tstate.params]
        gnorm = tts.global_norm(tgrads)
        assert (float(gnorm) > tcfg.grad_clip) == (scale >= 1.0)
        tts.apply_update(tstate, tgrads, gnorm, tcfg)
        assert_tree_close(tstate.params, np_tree(params), 2e-6, f"scale {scale} param")
        assert_tree_close(tstate.momentum, np_tree(opt_state[2].inner_state.trace), 2e-6, f"scale {scale} momentum")
        assert_tree_close(tstate.ema_params, np_tree(ema), 2e-6, f"scale {scale} EMA")
    assert (tstate.opt_step, tstate.ema_updates, int(opt_state[2].count)) == (3, 3, 3)


def test_trainer_hands_back_ema_and_bn_stats(world, tmp_path):
    """(f) `YOLO.train(batches=...)` over four batches returns, and the facade then holds the EMA
    parameters with the live BN statistics, which `predict` accepts."""
    path = tmp_path / "lpc-narrow.yaml"
    path.write_text(yaml.safe_dump(world["yaml"]))
    yolo = YOLO(path, device="cpu", seed=0)
    before = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    batches = [make_batch(10 + i) for i in range(4)]
    # SGD as asked: for nc 4 and a short run the "auto" rule would pick AdamW (test_auto_rule_matches_jax)
    out = yolo.train(batches=batches, epochs=1, optimizer="sgd", device="cpu", save_dir=tmp_path / "run")
    trainer = yolo.trainer
    assert isinstance(trainer, Trainer) and set(out) == set(
        ("box_om", "cls_om", "dfl_om", "box_oo", "cls_oo", "dfl_oo"))
    assert all(np.isfinite(v) for v in out.values())
    assert len(trainer.history) == 4 and not any(h["skipped"] for h in trainer.history)
    assert trainer.cfg.warmup_steps == 100 and trainer.cfg.total_steps == 4
    assert (trainer.state.step, trainer.state.ema_updates) == (4, 4)
    after = yolo.model.state_dict()
    assert not yolo.model.training
    for k, v in trainer.state.ema_params.items():
        assert torch.equal(after[k], v)
    for k, v in trainer.state.batch_stats.items():
        assert torch.equal(after[k], v) and not torch.equal(before[k], v)
    assert any(not torch.equal(before[k], after[k]) for k in trainer.state.ema_params)
    frames = [b["img"][0] for b in batches[:2]]
    results = yolo.predict(frames, imgsz=S, conf=0.0, batch=2, device="cpu")
    assert len(results) == 2 and all(np.isfinite(r.boxes.data).all() for r in results)


def test_entry_points_refuse_what_is_not_ported(world):
    tm = port_model(world)
    with pytest.raises(NotImplementedError):
        tts.make_train_step(tm, tts.OptConfig(), loss_kind="v8")
    with pytest.raises(NotImplementedError):
        tts.make_train_step(tm, tts.OptConfig(optimizer="lion"))
    # the transforms the data path does not carry: mosaic9, copy_paste, warpPerspective
    for hyp in ({"mosaic9": 0.5}, {"copy_paste": 0.3}, {"perspective": 0.001}):
        with pytest.raises(NotImplementedError):
            TrainTransforms(S, hyp)
    # the trainer's options not ported yet (save, save_period and resume are: tests/test_torch_ckpt.py)
    yolo = YOLO(device="cpu", seed=None)
    for kw in ({"cache_augmented": True}, {"batch": -1}):
        with pytest.raises(NotImplementedError):
            Trainer(yolo, data="data.yaml", epochs=1, device="cpu", **kw)
    # a folded serving copy cannot be trained as it is: train mode drops the fold, fold() refuses train mode
    from lpc_yolo_tpu_torch.nn.modules import ConvBN

    conv = ConvBN(8, 8, 3).eval()
    conv.fold(torch.float32)
    assert conv.folded is not None
    conv.train()
    assert conv.folded is None
    with pytest.raises(RuntimeError):
        conv.fold(torch.float32)


def test_adamw_matches_optax(world):
    """AdamW alone, on the same seeded gradients: three updates of the JAX package's chain (clip by the
    global norm, `optax.adamw` with b1 = 0.9, b2 = 0.999, eps = 1e-8 and the kernel-only decay mask) + its
    EMA against `apply_update`; params, both moments and the EMA within 2e-6 of each leaf's largest value.
    The first update moves no parameter (lr 0 at count 0); the bias correction counts from 1."""
    variables = world["variables"]
    jcfg = jts.OptConfig(**CFG, optimizer="adamw", momentum=0.9)
    tcfg = tts.OptConfig(**CFG, optimizer="adamw", momentum=0.9)
    update, params, opt_state, ema, n = optax_update(variables, jcfg)
    tstate = tts.init_train_state(port_model(world), tcfg, device="cpu")
    assert tstate.nu.keys() == tstate.params.keys()
    rng = np.random.default_rng(6)
    for scale in (3.0, 1.0, 1e-3):
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)
        opt_state, params, ema, n = update(grads, opt_state, params, ema, n)
        named = flax_to_state_dict({"params": grads})
        tgrads = [named[k].clone() for k in tstate.params]
        tts.apply_update(tstate, tgrads, tts.global_norm(tgrads), tcfg)
        adam = opt_state[1][0]
        assert_tree_close(tstate.params, np_tree(params), 2e-6, f"scale {scale} param")
        assert_tree_close(tstate.momentum, np_tree(adam.mu), 2e-6, f"scale {scale} first moment")
        assert_tree_close(tstate.nu, np_tree(adam.nu), 2e-6, f"scale {scale} second moment")
        assert_tree_close(tstate.ema_params, np_tree(ema), 2e-6, f"scale {scale} EMA")
    assert (tstate.opt_step, tstate.ema_updates, int(opt_state[1][0].count)) == (3, 3, 3)
    start = flax_to_state_dict({"params": variables["params"]})
    assert not torch.equal(tstate.params["model.0.conv.weight"], start["model.0.conv.weight"])


def test_adamw_state_bridge_round_trips(world):
    """An optax AdamW state after two updates carried into the port (mu as `momentum`, nu) and back: the
    trees come back bit for bit; the third update from the bridged state matches optax's within 2e-6 of each
    leaf's largest value, as `test_adamw_matches_optax` holds it. Without nu an AdamW state is refused."""
    variables = world["variables"]
    jcfg = jts.OptConfig(**CFG, optimizer="adamw", momentum=0.9)
    tcfg = tts.OptConfig(**CFG, optimizer="adamw", momentum=0.9)
    update, params, opt_state, ema, n = optax_update(variables, jcfg)
    rng = np.random.default_rng(7)
    draws = [jax.tree.map(lambda p: (s * rng.standard_normal(p.shape)).astype(np.float32), params)
             for s in (3.0, 1.0, 0.5)]
    for grads in draws[:2]:
        opt_state, params, ema, n = update(grads, opt_state, params, ema, n)
    adam = opt_state[1][0]
    trees = {"params": np_tree(params), "batch_stats": np_tree(variables["batch_stats"]),
             "momentum": np_tree(adam.mu), "ema_params": np_tree(ema), "nu": np_tree(adam.nu)}
    assert float(np.abs(np.concatenate([v.ravel() for v in jax.tree_util.tree_leaves(trees["nu"])])).max()) > 0
    tstate = train_state_from_flax(build_model(world["yaml"], device="cpu"), tcfg, trees["params"],
                                   trees["batch_stats"], trees["momentum"], trees["ema_params"], step=2,
                                   ema_updates=float(n), device="cpu", nu=trees["nu"])
    back = train_state_to_flax(tstate)
    assert back.keys() == trees.keys()
    for name, tree in trees.items():
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back[name]),
                                    jax.tree_util.tree_leaves_with_path(tree)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    opt_state, params, ema, n = update(draws[2], opt_state, params, ema, n)
    named = flax_to_state_dict({"params": draws[2]})
    tgrads = [named[k].clone() for k in tstate.params]
    tts.apply_update(tstate, tgrads, tts.global_norm(tgrads), tcfg)
    adam = opt_state[1][0]
    assert_tree_close(tstate.params, np_tree(params), 2e-6, "bridged AdamW param")
    assert_tree_close(tstate.momentum, np_tree(adam.mu), 2e-6, "bridged AdamW first moment")
    assert_tree_close(tstate.nu, np_tree(adam.nu), 2e-6, "bridged AdamW second moment")
    assert_tree_close(tstate.ema_params, np_tree(ema), 2e-6, "bridged AdamW EMA")
    with pytest.raises(ValueError, match="nu"):
        train_state_from_flax(build_model(world["yaml"], device="cpu"), tcfg, trees["params"], trees["batch_stats"],
                              trees["momentum"], trees["ema_params"], device="cpu")


def narrow_yaml_file(world, tmp_path) -> Path:
    path = tmp_path / "lpc-narrow.yaml"
    path.write_text(yaml.safe_dump(world["yaml"]))
    return path


class _Captured(Exception):
    """Carries the OptConfig a trainer reached, to stop it before it trains."""


@pytest.mark.parametrize("n_images, batch, epochs, nc", [(6, 4, 2, 3), (4, 4, 10_001, 3), (6, 4, 2, 25)],
                         ids=["short-few-classes", "long", "many-classes"])
def test_auto_rule_matches_jax(world, tmp_path, monkeypatch, n_images, batch, epochs, nc):
    """optimizer="auto" on a dataset: the JAX trainer and the port's reach the same OptConfig (AdamW with
    lr0 0.002 and b1 0.9 for <= 10000 steps on <= 20 classes, else SGD), each stopped where it builds its
    state."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    def capture(*args):
        raise _Captured(next(a for a in args if type(a).__name__ == "OptConfig"))

    path = narrow_yaml_file(world, tmp_path)
    data = make_synthetic_dataset(tmp_path / "ds", n_train=n_images, n_val=1, imgsz=32, nc=nc, max_boxes=2)
    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    monkeypatch.setattr(jax_trainer, "init_train_state", capture)
    monkeypatch.setattr(port_trainer, "init_train_state", capture)
    jy = jax_model.YOLO(str(path), nc=nc)
    with pytest.raises(_Captured) as ref:
        jax_trainer.Trainer(jy, data=data, epochs=epochs, batch=batch, workers=1,
                            save_dir=str(tmp_path / "run")).train()
    yolo = YOLO(path, device="cpu", seed=None, nc=nc)
    with pytest.raises(_Captured) as got:
        Trainer(yolo, data=data, epochs=epochs, batch=batch, workers=1, device="cpu",
                save_dir=tmp_path / "port_run").train()
    jcfg, tcfg = ref.value.args[0], got.value.args[0]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.optimizer == ("adamw" if (n_images, epochs, nc) == (6, 2, 3) else "sgd")


def test_seeded_nc3_yolo_equals_jax_facade(world, tmp_path, monkeypatch):
    """YOLO(cfg, nc=3, seed=0) builds the weights of the JAX facade's YOLO(cfg, nc=3) filled through
    `random_variables` from seed 0, with the same class names."""
    import lpc_yolo_tpu.engine.model as jax_model

    def seeded_init(model):
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
        return random_variables(shapes, seed=0)

    path = narrow_yaml_file(world, tmp_path)
    monkeypatch.setattr(jax_model, "_jit_init", seeded_init)
    jy = jax_model.YOLO(str(path), nc=3)
    yolo = YOLO(path, device="cpu", seed=0, nc=3)
    assert yolo.model.nc == jy.model.nc == 3 and yolo.names == jy.names == {0: "0", 1: "1", 2: "2"}
    ref = load_flax(build_model(world["yaml"], device="cpu", nc=3), jy.variables).state_dict()
    got = yolo.model.state_dict()
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in got)


def test_train_from_dataset_on_cpu(world, tmp_path, monkeypatch):
    """YOLO(cfg, nc=3).train(data=...) at imgsz 64, batch 4, 2 epochs, close_mosaic=1: AdamW by the "auto"
    rule, one epoch of mosaics (128x128 canvases) then one letterboxed (64x64), no step skipped, a results
    dict with the validator's keys that equals validating the handed-back facade (EMA weights, live BN
    statistics); a class-count mismatch raises."""
    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    canvases = []
    real_render = port_trainer.render

    def recording_render(plans, sources, device):
        canvases.append([p.canvas.hw for p in plans])
        return real_render(plans, sources, device)

    monkeypatch.setattr(port_trainer, "render", recording_render)
    path = narrow_yaml_file(world, tmp_path)
    data = make_synthetic_dataset(tmp_path / "ds", n_train=6, n_val=3, nc=3, max_boxes=3, seed=1,
                                  shapes=((80, 120), (64, 64), (48, 40)))
    yolo = YOLO(path, device="cpu", seed=0, nc=3)
    res = yolo.train(data=data, imgsz=S, batch=4, epochs=2, close_mosaic=1, workers=2, device="cpu",
                     save_dir=tmp_path / "run")
    trainer = yolo.trainer
    assert (trainer.cfg.optimizer, trainer.cfg.lr0, trainer.cfg.momentum) == ("adamw", 0.002, 0.9)
    assert canvases == [[(2 * S, 2 * S)] * 4] * 2 + [[(S, S)] * 4] * 2
    assert len(trainer.history) == 4 and not any(h["skipped"] for h in trainer.history)
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    assert set(res) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                        "fitness"}
    rows = trainer.epoch_history
    assert len(rows) == 2 and all(0 <= r["input_wait_frac"] + r["render_frac"] <= 1 for r in rows) and rows[-1].items() >= res.items()
    assert all(torch.equal(yolo.model.state_dict()[k], v) for k, v in trainer.state.ema_params.items())
    assert yolo.val(data=data, imgsz=S, batch=4, device="cpu") == res
    with pytest.raises(ValueError, match="nc"):
        YOLO(path, device="cpu", seed=None, nc=4).train(data=data, imgsz=S, batch=4, epochs=1, device="cpu",
                                                        save_dir=tmp_path / "run")


def test_training_defaults_to_cuda_and_raises_without_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tm = port_model(world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_train_state(tm, tts.OptConfig())
    yolo = YOLO(device="cpu", seed=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        yolo.train(batches=[make_batch(0)], epochs=1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(yolo, [make_batch(0)], epochs=1, device="cuda")


# The tests below need the compiled JAX step: they come last, so that its compile overlaps the tests above.


def port_first_trace(world, batch, dtype, cfg):
    """The port's loss on `batch` and what one update from zero momentum leaves in the momentum trace:
    the clipped gradient plus weight_decay * p on the kernels."""
    tm = port_model(world).to(dtype).train()
    dev_batch = tts.to_device(batch, torch.device("cpu"))
    dev_batch["img"] = dev_batch["img"].to(dtype)
    total, items = tts.make_loss_fn(tm)(dev_batch)
    total.backward()
    named = dict(tm.named_parameters())
    dead = [k for k, p in named.items() if p.grad is None]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in named.values()]
    gnorm = tts.global_norm(grads)
    trace = {k: g * (cfg.grad_clip / gnorm.clamp(min=cfg.grad_clip)) + (cfg.weight_decay * p if p.dim() == 4 else 0)
             for (k, p), g in zip(named.items(), grads)}
    return total.detach(), items, trace, dead


def test_loss_and_gradients_match_jax(world):
    """(b) one loss + backward. The JAX step's first update starts from zero momentum, so its trace afterwards
    is the clipped gradient (+ weight_decay * p on kernels): that is compared, per leaf and relative to its
    largest value, with the port run in f64 as the arbiter (see the module docstring): the port's f32 trace
    within 5e-4 of it, the JAX package's within 1e-2, and the two f32 sets within 1e-2 of each other. The
    floor of 1e-5 (1e-6 of the clipped global norm of 10) covers leaves whose gradient is zero (a BN bias
    feeding another BN) or tiny beside the others, which hold mostly noise. Total and items: rtol 1e-4."""
    batch, tcfg = as_f32(make_batch(0)), tts.OptConfig(**CFG)
    jstate, jmet = world["jstep"]()(world["jstate"], batch)
    total, items, t32, dead = port_first_trace(world, batch, torch.float32, tcfg)
    _, _, t64, _ = port_first_trace(world, batch, torch.float64, tcfg)
    np.testing.assert_allclose(float(total), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(jmet["items"]), rtol=1e-4)
    assert dead and all(k.startswith("model.27.") for k in dead)  # only the layer nothing reads has no gradient
    ref = flax_to_state_dict({"params": np_tree(momentum_of(jstate))})
    assert_named_close(t32, t64, 5e-4, "f32 trace against f64 of", floor=1e-5)
    assert_named_close(ref, t64, 1e-2, "JAX trace against the port's f64 of", floor=1e-5)
    assert_named_close(t32, ref, 1e-2, "trace of", floor=1e-5)


def bridge(world, jstate, tcfg):
    """The JAX TrainState carried into a new port model."""
    tm = build_model(world["yaml"], device="cpu")
    tstate = train_state_from_flax(tm, tcfg, np_tree(jstate.params), np_tree(jstate.batch_stats),
                                   np_tree(momentum_of(jstate)), np_tree(jstate.ema_params),
                                   step=int(jstate.step), ema_updates=float(jstate.ema_updates), device="cpu")
    return tstate, tts.make_train_step(tm, tcfg)


def assert_step_agrees(tstate, tmet, jstate, jmet, what, items_rtol, param_tol, momentum_tol, stats_atol):
    assert tmet["skipped"] is False and not bool(jmet["skipped"])
    np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=items_rtol)
    np.testing.assert_allclose(tmet["items"].numpy(), np.asarray(jmet["items"]), rtol=items_rtol)
    assert_tree_close(tstate.params, np_tree(jstate.params), param_tol, f"{what} param")
    assert_tree_close(tstate.momentum, np_tree(momentum_of(jstate)), momentum_tol, f"{what} momentum", floor=1e-6)
    assert_tree_close(tstate.ema_params, np_tree(jstate.ema_params), param_tol, f"{what} EMA")
    assert_stats_close(tstate.batch_stats, np_tree(jstate.batch_stats), stats_atol, f"{what} BN statistic")
    assert (tstate.step, tstate.ema_updates) == (int(jstate.step), int(jstate.ema_updates))


def test_three_steps_from_a_bridged_state(world):
    """(c) JAX takes one step; its state (momentum filled, EMA off the params, counts at 1) is carried
    across the bridge, and both then take three more (lr at optimizer counts 1, 2, 3).

    Two port runs are held to JAX after every step. `run` goes on from its own state, as training does; its
    distance from JAX grows about tenfold a step, because both sides' f32 noise feeds back through the
    parameters of this tiny model at batch 2 (module docstring; params reach 1.5e-4 of a leaf's largest value
    after two steps and 1.4e-3 after three). It guards against gross faults in carrying the port's own state
    from step to step: items rtol 5e-2, params and EMA 5e-3, momentum 1e-1, BN statistics atol 5e-3. `fresh` is bridged anew from the JAX
    state before each step, so each of its steps starts from the same numbers as JAX's: items rtol 1e-4,
    params and EMA 2e-4 (1.2e-4 reached: lr times the gradients' noise), momentum 1e-2, BN statistics 5e-5. `model.27.*` (no gradient, yet decayed) is in
    every comparison like any other leaf."""
    jstate, jstep = world["jstate"], world["jstep"]()
    jstate, jm0 = jstep(jstate, as_f32(make_batch(0)))
    assert float(jm0["lr"]) == 0.0  # the schedule starts at 0: the first step moves no parameter
    first = flax_to_state_dict({"params": np_tree(jstate.params)})
    start = flax_to_state_dict({"params": world["variables"]["params"]})
    assert all(torch.equal(first[k], start[k]) for k in first)

    tcfg = tts.OptConfig(**CFG)
    run, run_step = bridge(world, jstate, tcfg)
    assert (run.step, run.opt_step, run.ema_updates) == (1, 1, 1)
    # the bridge's inverse gives the JAX trees back bit for bit
    back = train_state_to_flax(run)
    for name, tree in (("params", jstate.params), ("batch_stats", jstate.batch_stats),
                       ("ema_params", jstate.ema_params), ("momentum", momentum_of(jstate))):
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back[name]),
                                    jax.tree_util.tree_leaves_with_path(np_tree(tree))):
            assert pa == pb
            np.testing.assert_array_equal(a, b)

    for i in (1, 2, 3):
        batch = as_f32(make_batch(i))
        fresh, fresh_step = bridge(world, jstate, tcfg)
        jstate, jmet = jstep(jstate, batch)
        run, rmet = run_step(run, batch)
        fresh, fmet = fresh_step(fresh, batch)
        assert rmet["lr"] > 0 and int(jstate.step) == i + 1
        assert_step_agrees(run, rmet, jstate, jmet, f"run, step {i}", 5e-2, 5e-3, 1e-1, 5e-3)
        assert_step_agrees(fresh, fmet, jstate, jmet, f"fresh, step {i}", 1e-4, 2e-4, 1e-2, 5e-5)
    # the parameters moved, and the dead layer's kernels decayed and its momentum holds wd * p, as in JAX
    k = "model.27.cv1.conv.weight"
    assert not torch.equal(run.params["model.0.conv.weight"], start["model.0.conv.weight"])
    assert not torch.equal(run.params[k], start[k]) and run.momentum[k].abs().max() > 0


def test_non_finite_step_is_skipped(world):
    """(d) a NaN pixel: loss and gradients are non-finite, so nothing changes but `step`,
    in the port as in JAX; the next good step then uses the schedule at the unmoved optimizer count."""
    tm = port_model(world)
    tcfg = tts.OptConfig(**CFG)
    tstate = tts.init_train_state(tm, tcfg, device="cpu")
    tstep = tts.make_train_step(tm, tcfg)
    tstate, _ = tstep(tstate, as_f32(make_batch(0)))  # fill momentum, move BN statistics and EMA count
    snap = {name: {k: v.detach().clone() for k, v in getattr(tstate, name).items()}
            for name in ("params", "batch_stats", "momentum", "ema_params")}
    bad = as_f32(make_batch(1))
    bad["img"][0, 5, 7, 1] = np.nan
    tstate, tmet = tstep(tstate, bad)
    assert tmet["skipped"] is True and not np.isfinite(float(tmet["loss"]))
    assert (tstate.step, tstate.opt_step, tstate.ema_updates) == (2, 1, 1)
    for name, tensors in snap.items():
        for k, v in tensors.items():
            assert torch.equal(getattr(tstate, name)[k], v), f"{name} {k} changed on a skipped step"

    jstate, jstep = world["jstate"], world["jstep"]()
    jstate, _ = jstep(jstate, as_f32(make_batch(0)))
    jafter, jmet = jstep(jstate, bad)
    assert bool(jmet["skipped"]) and int(jafter.step) == 2 and float(jafter.ema_updates) == 1.0
    assert int(jafter.opt_state[2].count) == 1  # the optimizer's count did not advance
    np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    # one more good step on both: still in agreement (lr read at the optimizer's count, not at `step`)
    good = as_f32(make_batch(2))
    jafter, jmet = jstep(jafter, good)
    tstate, tmet = tstep(tstate, good)
    assert tmet["skipped"] is False and tstate.opt_step == 2 and tstate.step == 3
    assert_tree_close(tstate.params, np_tree(jafter.params), 5e-4, "param after a skip")
    assert_tree_close(tstate.momentum, np_tree(momentum_of(jafter)), 2e-2, "momentum after a skip", floor=1e-6)


def test_packed_feed_equals_unpacked_feed(world):
    """(e) the (B, H, W/8, 24) uint8 feed and the (B, H, W, 3) uint8 feed give the same step bit for bit,
    and that step matches the JAX step on the same frames."""
    batch = make_batch(3)
    packed = {**batch, "img": pack_img(batch["img"])}
    assert packed["img"].shape == (B, S, S // 8, 24) and np.shares_memory(packed["img"], batch["img"])
    tcfg = tts.OptConfig(**CFG)
    results = []
    for feed in (batch, packed):
        tm = port_model(world)
        tstate = tts.init_train_state(tm, tcfg, device="cpu")
        tstep = tts.make_train_step(tm, tcfg)
        tstate, met = tstep(tstate, feed)
        tstate, met2 = tstep(tstate, feed)  # lr > 0 on the second: the parameters move
        results.append((met, met2, tstate))
    (a1, a2, sa), (b1, b2, sb) = results
    for x, y in ((a1, b1), (a2, b2)):
        assert torch.equal(x["loss"], y["loss"]) and torch.equal(x["items"], y["items"])
    for name in ("params", "batch_stats", "momentum", "ema_params"):
        assert all(torch.equal(v, getattr(sb, name)[k]) for k, v in getattr(sa, name).items()), name
    jstate, jmet = world["jstep"]()(world["jstate"], as_f32(batch))
    np.testing.assert_allclose(float(a1["loss"]), float(jmet["loss"]), rtol=1e-4)
    np.testing.assert_allclose(a1["items"].numpy(), np.asarray(jmet["items"]), rtol=1e-4)
