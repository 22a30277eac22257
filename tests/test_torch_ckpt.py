"""Checkpoints and the rest of the epoch loop of the port against the JAX package, on the CPU.

The model is the LPC-YOLO YAML's own layer list at small channel counts
(widths 8-32, as `tests/test_torch_train.py`), nc 3, imgsz 64. No JAX train
step is compiled: the JAX states come from `init_train_state` with their
leaves filled from a numpy seed, and only the JAX forward of `predict` is
compiled once. Checkpoints are compared bit for bit: the bytes of the flax
msgpack, every leaf with its dtype, the counters.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization
from lpc_yolo_tpu.engine import train_step as jts
from lpc_yolo_tpu.nn import build_model as jax_build

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.engine import train_step as tts
from lpc_yolo_tpu_torch.engine.trainer import EarlyStopping
from lpc_yolo_tpu_torch.nn import build_model
from lpc_yolo_tpu_torch.utils import msgpack
from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint, read_meta, save_checkpoint, write_checkpoint
from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
from lpc_yolo_tpu_torch.utils.flax_bridge import (injected_momentum, random_variables, train_state_dict,
                                                  train_state_from_dict)
from lpc_yolo_tpu_torch.utils.infra import get_save_dir, increment_path

ROOT = Path(__file__).resolve().parents[1]
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
S, NC = 64, 3
CFG = {"sgd": dict(warmup_steps=5, total_steps=20),
       "adamw": dict(warmup_steps=5, total_steps=20, optimizer="adamw", lr0=0.002, momentum=0.9)}


def narrow_yaml() -> dict:
    d = yaml.safe_load(PORT_YAML.read_text())
    d.update(nc=4, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    return d


def seeded_init(model):
    """The JAX facade's `_jit_init` without compiling: the variables' shapes filled from seed 0."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), training=True))
    return random_variables(shapes, seed=0)


def np_state_dict(jstate) -> dict:
    return serialization.to_state_dict(jax.device_get(jstate))


def assert_trees_equal(got, ref, where=""):
    """Same keys in the same order at every level, and every leaf equal bit for bit with its dtype."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), f"{where}: keys {list(got)} != {list(ref)}"
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{where}/{k}")
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape, f"{where}: {got.dtype}{got.shape} != {ref.dtype}{ref.shape}"
        assert got.tobytes() == ref.tobytes(), f"{where}: values differ"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These models are tiny: beside a test run's other workers more torch threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The narrow YAML (as a file too), a synthetic dataset of 8 + 2 frames, and the JAX model at nc 3."""
    tmp = tmp_path_factory.mktemp("ckpt")
    d = narrow_yaml()
    path = tmp / "lpc-narrow.yaml"
    path.write_text(yaml.safe_dump(d))
    data = make_synthetic_dataset(tmp / "ds", n_train=8, n_val=2, imgsz=S, nc=NC, max_boxes=3, seed=1)
    jm = jax_build(d, nc=NC)
    return {"yaml": d, "path": path, "data": data, "jm": jm, "variables": seeded_init(jm), "tmp": tmp}


def filled_jax_state(world, opt: str, seed: int, count: int = 5):
    """A JAX TrainState of `opt` whose every float leaf is drawn from a numpy seed, after `count`
    updates and `count + 2` steps (two skipped); `decay` is what optax holds after `count` updates."""
    jcfg = jts.OptConfig(**CFG[opt])
    jstate, _ = jts.init_train_state(world["jm"], world["variables"], jcfg)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jstate)
    out = []
    for path, leaf in leaves:
        name = jax.tree_util.keystr(path)
        if name.endswith(".count"):
            out.append(np.asarray(count, np.int32))
        elif name.endswith(".step"):
            out.append(np.asarray(count + 2, np.int32))
        elif name.endswith(".ema_updates"):
            out.append(np.asarray(count, np.float32))
        elif "decay" in name:
            out.append(injected_momentum(count, jcfg))
        else:
            out.append(rng.standard_normal(leaf.shape).astype(np.float32))
    assert all(np.asarray(a).dtype == np.asarray(b).dtype for a, (_, b) in zip(out, leaves))
    return jax.tree_util.tree_unflatten(treedef, out)


# -- the codec ---------------------------------------------------------------------------------


def test_codec_headers_match_flax():
    """Every header width msgpack chooses, ext 1 (arrays of several dtypes) and ext 3 (numpy scalars),
    against flax's `msgpack_serialize` of the same tree; and back."""
    rng = np.random.default_rng(0)
    tree = {"empty": {}, "np_scalar": np.float32(3.5), "np_int": np.int32(-7), "np_bool": np.bool_(True),
            "zero_d": np.zeros((), np.int32), "fixstr": "x" * 31, "str8": "y" * 32, "str16": "z" * 300,
            "utf8": "é€", "f32": rng.standard_normal((70, 30)).astype(np.float32),
            "u8": rng.integers(0, 256, (3, 100), dtype=np.uint8), "bool": np.ones(3, bool),
            "i64": np.arange(-5, 5, dtype=np.int64), "f64": rng.random(4),
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, -1, -32, -33, -128, -129,
                     -2 ** 15, -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1],
            "float": 1.5, "none": None, "true": True, "false": False, "bin8": b"a" * 10, "bin16": b"b" * 300,
            "bin32": b"c" * 70000, "map16": {f"k{i}": i for i in range(16)}, "array16": list(range(16)),
            "map32": {f"k{i}": i for i in range(70000)}}
    ref = serialization.msgpack_serialize(tree, in_place=True)
    assert msgpack.to_bytes(tree) == ref
    back, flax_back = msgpack.from_bytes(ref), serialization.msgpack_restore(ref)
    for k, v in flax_back.items():
        if isinstance(v, (np.ndarray, np.generic)):
            assert type(back[k]) is type(v) and np.asarray(back[k]).dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(back[k], v)
        else:
            assert back[k] == v, k


def test_codec_refuses_what_flax_would_chunk():
    """A leaf over flax's 2**30-byte chunk size is refused (flax would split it; a broadcast view
    makes one without allocating it), and so are flax's chunked leaves and trailing bytes."""
    big = np.broadcast_to(np.zeros(1, np.float32), (2 ** 28 + 1,))
    with pytest.raises(ValueError, match="chunks"):
        msgpack.to_bytes({"w": big})
    chunked = msgpack.to_bytes({"w": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.from_bytes(chunked)
    with pytest.raises(ValueError, match="trailing"):
        msgpack.from_bytes(msgpack.to_bytes({"a": 1}) + b"\x00")


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_state_bytes_match_flax(world, opt):
    """The LPC model's JAX TrainState (seeded leaves): the codec's bytes of its state dict equal
    `flax.serialization.to_bytes` of the state, and decoding flax's bytes gives that state dict back
    (keys in order, dtypes, values)."""
    jstate = jax.device_get(filled_jax_state(world, opt, seed=1))
    ref = serialization.to_bytes(jstate)
    sd = serialization.to_state_dict(jstate)
    assert msgpack.to_bytes(sd) == ref
    assert_trees_equal(msgpack.from_bytes(ref), sd)


def test_injected_momentum_matches_optax():
    """The `decay` that optax's inject_hyperparams holds after n updates of the JAX package's SGD chain,
    for n across the warmup and past it, equals `injected_momentum(n)` bit for bit."""
    import optax

    jcfg = jts.OptConfig(warmup_steps=7, total_steps=30)
    params = {"a": {"kernel": jnp.ones((2, 2, 1, 1))}, "b": {"bias": jnp.ones((3,))}}
    tx = jts.make_optimizer(params, jcfg)
    state = tx.init(params)
    for n in range(11):
        assert int(state[2].count) == n
        assert np.asarray(state[2].hyperparams["decay"]).tobytes() == injected_momentum(n, jcfg).tobytes(), n
        updates, state = tx.update(jax.tree.map(lambda p: 0.1 * p, params), state, params)
        params = optax.apply_updates(params, updates)


# -- train states both ways --------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_jax_checkpoint_resumes_in_the_port(world, tmp_path, opt):
    """A JAX `save_checkpoint` of a seeded TrainState -> the port's `load_checkpoint` ->
    `train_state_from_dict`: every leaf equals the source (params, BN statistics, moments, EMA),
    the counters too (step 7, 5 updates), and the port's state dict of it encodes to the very bytes
    the JAX package wrote. A state of the other optimizer is refused."""
    from lpc_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save

    jstate = filled_jax_state(world, opt, seed=2)
    path = tmp_path / "last.ckpt"
    jax_save(path, jstate, {"epoch": 4, "fitness": 0.25})
    tree, meta = load_checkpoint(path)
    assert meta == {"epoch": 4, "fitness": 0.25}
    cfg = tts.OptConfig(**CFG[opt])
    tstate = train_state_from_dict(build_model(world["yaml"], device="cpu", nc=NC), cfg, tree, device="cpu")
    assert (tstate.step, tstate.opt_step, tstate.ema_updates) == (7, 5, 5)
    got = train_state_dict(tstate, cfg)
    assert_trees_equal(got, np_state_dict(jstate))
    blob = path.read_bytes()
    assert msgpack.to_bytes(got) == blob[8 + int.from_bytes(blob[:8], "little"):]
    other = tts.OptConfig(**CFG["adamw" if opt == "sgd" else "sgd"])
    with pytest.raises(ValueError, match="optimizer settings"):
        train_state_from_dict(build_model(world["yaml"], device="cpu", nc=NC), other, tree, device="cpu")


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """The port's runs that the tests below read, each trained once:

    default: `train(data=...)` with no save arguments, from a working directory of its own and with a
      settings directory of its own that holds no settings file (so the runs root is ./runs whatever
      earlier tests wrote there), AdamW by the "auto" rule, 3 epochs, close_mosaic=2, save_period=1;
    stopped: the same run under name="stopped", stopped (SIGTERM) in the first step of its third
      epoch, then resumed with resume=True (it runs epoch 3 again);
    sgd: `train(batches=...)`, SGD, 2 epochs of 2 batches, into an explicit save_dir.
    """
    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    tmp = tmp_path_factory.mktemp("runs")
    kw = dict(data=world["data"], imgsz=S, batch=4, epochs=3, close_mosaic=2, workers=2, device="cpu")
    cwd, config = os.getcwd(), os.environ.get("LPC_YOLO_CONFIG_DIR")
    os.chdir(tmp)
    os.environ["LPC_YOLO_CONFIG_DIR"] = str(tmp / "cfg")
    real_render = port_trainer.render
    out = {"tmp": tmp}
    try:
        out["default"] = YOLO(world["path"], device="cpu", seed=0, nc=NC)
        out["default_results"] = out["default"].train(save_period=1, **kw)

        calls, canvases = [], []

        def stopping_render(plans, sources, device):
            calls.append(len(calls))
            if len(calls) == 5:  # epoch 3, step 1: the step finishes, then the run stops
                trainer = out["stopped"].trainer
                assert signal.getsignal(signal.SIGTERM) == trainer._request_stop
                signal.raise_signal(signal.SIGTERM)
            return real_render(plans, sources, device)

        port_trainer.render = stopping_render
        handler = signal.getsignal(signal.SIGTERM)
        out["stopped"] = YOLO(world["path"], device="cpu", seed=0, nc=NC)
        out["stopped"].train(name="stopped", **kw)
        assert signal.getsignal(signal.SIGTERM) == handler  # restored
        shutil.copytree(tmp / "runs" / "v10" / "stopped", tmp / "stopped_copy")

        def recording_render(plans, sources, device):
            canvases.append([p.canvas.hw for p in plans])
            return real_render(plans, sources, device)

        port_trainer.render = recording_render
        out["resumed"] = YOLO(world["path"], device="cpu", seed=0, nc=NC)
        out["resumed"].train(name="stopped", resume=True, **kw)
        out["resumed_canvases"] = canvases
        port_trainer.render = real_render

        batches = [make_host_batch(10 + i) for i in range(2)]
        out["sgd"] = YOLO(world["path"], device="cpu", seed=0, nc=NC)
        out["sgd"].train(batches=batches, epochs=2, optimizer="sgd", device="cpu", save_dir=tmp / "sgd")
    finally:
        port_trainer.render = real_render
        os.chdir(cwd)
        if config is None:
            os.environ.pop("LPC_YOLO_CONFIG_DIR", None)
        else:
            os.environ["LPC_YOLO_CONFIG_DIR"] = config
    assert not (tmp / "cfg").exists()  # read, never written
    return out


def make_host_batch(seed: int, b: int = 2, m: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 30, (b, m, 2))
    mask = np.arange(m)[None] < rng.integers(1, m + 1, (b, 1))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (b, m, 2))], -1).astype(np.float32)
    return {"img": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8),
            "cls": rng.integers(0, NC, (b, m)).astype(np.int32), "bboxes": boxes * mask[..., None], "mask": mask}


def test_default_run_writes_the_jax_files(runs):
    """With no save arguments `train(data=...)` writes runs/v10/train/weights/{last,best}.ckpt, an
    epoch{N}.ckpt every save_period epochs from epoch 1, and results.csv with one row per epoch, as
    the JAX trainer does; last.ckpt's meta is the final epoch's."""
    run = runs["tmp"] / "runs" / "v10" / "train"
    trainer = runs["default"].trainer
    assert trainer.save_dir.resolve() == run.resolve()
    files = sorted(p.name for p in (run / "weights").iterdir())
    assert files == ["best.ckpt", "epoch1.ckpt", "epoch2.ckpt", "last.ckpt"]
    rows = (run / "results.csv").read_text().splitlines()
    assert len(rows) == 4
    fitness = trainer.epoch_history[-1]["fitness"]
    assert read_meta(run / "weights" / "last.ckpt") == {"epoch": 2, "fitness": fitness}
    assert len(trainer.ckpt_seconds) == 3 and all(c["bytes"] > 0 for c in trainer.ckpt_seconds)


def test_results_csv_follows_the_jax_rules(runs, world, tmp_path, monkeypatch):
    """results.csv against the JAX trainer's own rows: both trainers run 2 epochs on the dataset with
    the same stub train step (the same f32 loss items and schedule lr a step, the lr as each package's
    step returns it: f32 from JAX, a Python float from the port) and the same stub validation (the
    keys of the port's validator, values of many digits). The port writes the JAX header with its
    render_frac last, the same epoch, loss, validation and lr cells as strings, and its timing cells
    rounded as JAX rounds them (time_s to 0.1, the fractions to 1e-4). The default run's header is
    that header too."""
    import types

    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu.engine.trainer as jax_trainer

    import lpc_yolo_tpu_torch.engine.trainer as port_trainer

    rng = np.random.default_rng(4)
    items = rng.uniform(0, 5, (8, 6)).astype(np.float32)
    lrs = rng.uniform(0, 0.002, 8)  # float64, as the port's schedule
    keys = list(runs["default_results"])
    results = [dict(zip(keys, rng.uniform(0, 1, len(keys)).tolist())) for _ in range(2)]

    def counting(make):
        n = iter(range(8))
        return lambda *a, **k: make(next(n))

    jax_step = counting(lambda i: {"items": items[i], "skipped": np.asarray(False), "lr": jnp.float32(lrs[i])})
    port_step = counting(lambda i: {"loss": torch.tensor(0.0), "items": torch.from_numpy(items[i]),
                                    "lr": float(lrs[i]), "skipped": False})
    jax_results, port_results = counting(lambda i: results[i]), counting(lambda i: results[i])

    class StubValidator:
        def __init__(self, *a, **k):
            pass

        __call__ = staticmethod(jax_results)

    monkeypatch.setattr(jax_model, "_jit_init", lambda model: None)
    monkeypatch.setattr(jax_trainer, "init_train_state",
                        lambda *a: (types.SimpleNamespace(ema_params={}, batch_stats={}), None))
    monkeypatch.setattr(jax_trainer, "make_train_step", lambda *a, **k: lambda state, batch: (state, jax_step()))
    monkeypatch.setattr(jax_trainer, "data_parallel_mesh", lambda **k: None)
    monkeypatch.setattr(jax_trainer, "replicate", lambda state, mesh: state)
    monkeypatch.setattr(jax_trainer, "shard_batch", lambda batch, mesh: batch)
    monkeypatch.setattr(jax_trainer, "Validator", StubValidator)
    monkeypatch.setattr(jax_trainer, "save_checkpoint", lambda *a: None)
    monkeypatch.setattr(port_trainer, "make_train_step", lambda *a, **k: lambda state, batch: (state, port_step()))
    monkeypatch.setattr(port_trainer.Trainer, "validate", lambda self, model, state: port_results())
    kw = dict(data=world["data"], epochs=2, batch=4, imgsz=S, workers=1, optimizer="adamw")
    jy = jax_model.YOLO(str(world["path"]), nc=NC)
    jax_trainer.Trainer(jy, save_dir=str(tmp_path / "jax"), **kw).train()
    yolo = YOLO(world["path"], device="cpu", seed=0, nc=NC)
    port_trainer.Trainer(yolo, save_dir=tmp_path / "port", device="cpu", **kw).train()

    ref, got = ((tmp_path / n / "results.csv").read_text().splitlines() for n in ("jax", "port"))
    header = ref[0].split(",")
    assert header[:2] == ["epoch", "train/box_om"] and header[-3:] == ["lr", "time_s", "input_wait_frac"]
    assert got[0].split(",") == header + ["render_frac"] and len(got) == len(ref) == 3
    timing = {"time_s": 1, "input_wait_frac": 4, "render_frac": 4}
    for r, g in zip(ref[1:], got[1:]):
        rj, rp = dict(zip(header, r.split(","))), dict(zip(header + ["render_frac"], g.split(",")))
        assert {k: v for k, v in rp.items() if k not in timing} == {k: v for k, v in rj.items() if k not in timing}
        for k, digits in timing.items():
            assert float(rp[k]) == round(float(rp[k]), digits) and (k not in rj or float(rj[k]) == round(float(rj[k]), digits))
    with open(runs["tmp"] / "runs" / "v10" / "train" / "results.csv") as f:
        assert f.readline().strip().split(",") == header + ["render_frac"]


def test_resumed_run_equals_the_uninterrupted_run(runs):
    """A run stopped in its third epoch (close_mosaic=2: mosaic is off from epoch 2) and resumed with
    resume=True equals the run that was never stopped, bit for bit: the resume finds the newest
    "stopped*" run with a last.ckpt (a fresh name would be stopped2), starts at epoch 3 from the saved
    counters, draws that epoch's shuffle and letterboxes it (where the JAX trainer would restart the
    loader at epoch 0 and keep mosaic on), and ends with the same state, last.ckpt and results rows."""
    ref, stopped, resumed = runs["default"].trainer, runs["stopped"].trainer, runs["resumed"].trainer
    assert stopped.preempted and len(stopped.history) == 5 and len(stopped.epoch_history) == 2
    assert read_meta(runs["tmp"] / "stopped_copy" / "weights" / "last.ckpt")["epoch"] == 1
    assert resumed.save_dir.resolve() == (runs["tmp"] / "runs" / "v10" / "stopped").resolve()
    assert resumed.start_epoch == 2
    assert [h["epoch"] for h in resumed.history] == [2, 2] and runs["resumed_canvases"] == [[(S, S)] * 4] * 2
    assert (resumed.state.step, resumed.state.opt_step, resumed.state.ema_updates) == (6, 6, 6)
    assert_trees_equal(train_state_dict(resumed.state, resumed.cfg), train_state_dict(ref.state, ref.cfg))
    a, b = (runs["tmp"] / "runs" / "v10" / n / "weights" / "last.ckpt" for n in ("train", "stopped"))
    assert a.read_bytes() == b.read_bytes()
    ra, rb = ((runs["tmp"] / "runs" / "v10" / n / "results.csv").read_text().splitlines() for n in ("train", "stopped"))
    timing = slice(-3, None)  # time_s, input_wait_frac, render_frac
    assert [r.split(",")[:-3] for r in ra] == [r.split(",")[:-3] for r in rb] and len(rb) == 4
    assert all(r.split(",")[timing] for r in rb)
    sd_ref, sd_res = runs["default"].model.state_dict(), runs["resumed"].model.state_dict()
    assert all(torch.equal(sd_ref[k], sd_res[k]) for k in sd_ref)


def test_resume_restores_the_best_fitness(runs, world):
    """The best fitness and EarlyStopping's best epoch come back from best.ckpt's meta: a resume whose
    best.ckpt says epoch 0 reached 0.5 keeps that best.ckpt (the resumed epoch's fitness is lower),
    and with patience 2 the stopper counts from epoch 0 (the JAX trainer would restart both at 0 and
    overwrite best.ckpt)."""
    run = runs["tmp"] / "stopped_copy"
    best = run / "weights" / "best.ckpt"
    blob = best.read_bytes()
    write_checkpoint(best, blob[8 + int.from_bytes(blob[:8], "little"):], {"epoch": 0, "fitness": 0.5})
    yolo = YOLO(world["path"], device="cpu", seed=0, nc=NC)
    yolo.train(data=world["data"], imgsz=S, batch=4, epochs=3, close_mosaic=2, workers=2, device="cpu",
               save_dir=run, resume=True, patience=2)
    trainer = yolo.trainer
    assert trainer.start_epoch == 2 and (trainer.stopper.best_epoch, trainer.stopper.best_fitness) == (0, 0.5)
    assert trainer.epoch_history[-1]["fitness"] < 0.5
    assert read_meta(best) == {"epoch": 0, "fitness": 0.5}
    assert read_meta(run / "weights" / "last.ckpt")["epoch"] == 2


@pytest.mark.parametrize("run_name", ["default", "sgd"])
def test_port_checkpoint_resumes_in_jax(runs, world, run_name):
    """The port's last.ckpt (AdamW from the dataset run, SGD from the batches run) restored by the JAX
    package's `load_checkpoint(path, template)` into its TrainState: every leaf and counter equals the
    port's final state bit for bit. The batches run has no validation, so it wrote no best.ckpt."""
    from lpc_yolo_tpu.utils.checkpoint import load_checkpoint as jax_load

    trainer = runs[run_name].trainer
    jcfg = jts.OptConfig(**{k: getattr(trainer.cfg, k) for k in ("lr0", "momentum", "warmup_steps", "total_steps",
                                                                    "optimizer")})
    template, _ = jts.init_train_state(world["jm"], world["variables"], jcfg)
    weights = trainer.save_dir
    jstate, meta = jax_load(weights / "weights" / "last.ckpt", template)
    assert_trees_equal(np_state_dict(jstate), train_state_dict(trainer.state, trainer.cfg))
    assert int(jstate.step) == trainer.state.step == (6 if run_name == "default" else 4)
    assert meta["epoch"] == (2 if run_name == "default" else 1)
    assert (weights / "weights" / "best.ckpt").exists() == (run_name == "default")
    assert len((weights / "results.csv").read_text().splitlines()) == (4 if run_name == "default" else 3)


def test_trainer_checkpoint_is_not_a_model(runs):
    """A trainer's last.ckpt has no model config: the port's YOLO() refuses it with the JAX message, as
    the JAX facade does."""
    import lpc_yolo_tpu.engine.model as jax_model

    path = runs["tmp"] / "runs" / "v10" / "train" / "weights" / "last.ckpt"
    with pytest.raises(ValueError, match="has no embedded model config"):
        YOLO(path, device="cpu")
    with pytest.raises(ValueError, match="has no embedded model config"):
        jax_model.YOLO(str(path))


# -- the facade ---------------------------------------------------------------------------------


def test_yolo_save_loads_in_both_packages(tmp_path, monkeypatch):
    """LPC-YOLO at full width, nc 3: `YOLO.save` in the port -> the JAX `YOLO(path)`: the same variables bit for bit, nc, task and
    names, and the same detections on seeded frames (`utils/compare.py`; frames that need no resize,
    so both feeds are byte-equal: scores within 1e-6, boxes within 1e-3). Then that JAX model's
    `save` -> the port's `YOLO(path)`: the same weights again, the same names (JSON's str keys mapped
    back to int), and the port's detections unchanged."""
    import lpc_yolo_tpu.engine.model as jax_model

    from lpc_yolo_tpu_torch.utils.flax_bridge import state_dict_to_flax

    monkeypatch.setattr(jax_model, "_jit_init", seeded_init)
    yolo = YOLO(device="cpu", seed=5, nc=NC)  # full width: the JAX serving graph packs the narrow one wrongly at 64
    yolo.names = {0: "red", 1: "green", 2: "blue"}
    p1 = yolo.save(tmp_path / "port.ckpt")
    jy = jax_model.YOLO(p1)
    assert (jy.model.nc, jy.task, jy.names) == (NC, "v10", yolo.names)
    assert_trees_equal(jax.device_get(jy.variables), state_dict_to_flax(yolo.model.state_dict()))
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((64, 48, 3), (48, 64, 3))]
    ours = yolo.predict(frames, imgsz=S, conf=0.0, batch=2, device="cpu")
    theirs = jy.predict(frames, imgsz=S, conf=0.0, batch=2)
    for r, j in zip(ours, theirs):
        assert len(r) > 0
        assert_detections_close(r.boxes.data, np.asarray(j.boxes.data), atol_box=1e-3, atol_score=1e-6)
    p2 = jy.save(str(tmp_path / "jax.ckpt"))
    back = YOLO(p2, device="cpu")
    assert (back.model.nc, back.task, back.names) == (NC, "v10", yolo.names)
    a, b = back.model.state_dict(), yolo.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    again = back.predict(frames, imgsz=S, conf=0.0, batch=2, device="cpu")
    for r, o in zip(again, ours):
        np.testing.assert_array_equal(r.boxes.data, o.boxes.data)


def test_yolo_load_takes_matching_weights(world, tmp_path):
    """`YOLO.load` takes every weight whose name and shape match (the JAX facade's rule): from a model
    of another class count every weight but the class heads' last convs, from a `.ckpt` path all."""
    src = YOLO(world["path"], device="cpu", seed=6, nc=5)
    dst = YOLO(world["path"], device="cpu", seed=7, nc=NC)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    dst.load(src)
    theirs = src.model.state_dict()
    kept = sorted(k for k, v in dst.model.state_dict().items() if not torch.equal(v, theirs[k]))
    assert kept and all(theirs[k].shape != v.shape for k, v in before.items() if k in kept)
    assert all(torch.equal(dst.model.state_dict()[k], before[k]) for k in kept)
    same = YOLO(world["path"], device="cpu", seed=8, nc=NC)
    path = same.save(tmp_path / "same.ckpt")
    dst.load(path)
    assert all(torch.equal(v, same.model.state_dict()[k]) for k, v in dst.model.state_dict().items())


# -- the loop's rules and the run directory ------------------------------------------------------


@pytest.mark.parametrize("patience", [0, 1, 3])
def test_early_stopping_matches_jax(patience):
    """EarlyStopping against the JAX trainer's on the same fitness sequence, epoch by epoch."""
    from lpc_yolo_tpu.engine.trainer import EarlyStopping as JaxEarlyStopping

    fitness = [0.0, 0.1, 0.1, 0.05, 0.2, 0.19, 0.18, 0.17, 0.16, 0.3, 0.0, 0.0, 0.0, 0.0]
    ours, theirs = EarlyStopping(patience), JaxEarlyStopping(patience)
    for epoch, f in enumerate(fitness):
        assert ours(epoch, f) == theirs(epoch, f), (epoch, f)
        assert (ours.best_epoch, ours.best_fitness) == (theirs.best_epoch, theirs.best_fitness)


def test_run_directory_matches_jax(tmp_path, monkeypatch):
    """`increment_path` and `get_save_dir` against the JAX package's: exp, exp2, ... unless exist_ok,
    files keep their suffix; the runs root is the settings file's `runs_dir` when it names one (read,
    never written), else ./runs."""
    from lpc_yolo_tpu.utils.infra import increment_path as jax_increment

    (tmp_path / "exp").mkdir()
    (tmp_path / "exp2").mkdir()
    (tmp_path / "f.txt").write_text("")
    for p, kw in ((tmp_path / "exp", {}), (tmp_path / "exp", {"exist_ok": True}), (tmp_path / "new", {}),
                  (tmp_path / "f.txt", {})):
        assert increment_path(p, **kw) == jax_increment(p, **kw)
    monkeypatch.chdir(tmp_path)
    config = tmp_path / "config"
    monkeypatch.setenv("LPC_YOLO_CONFIG_DIR", str(config))
    assert get_save_dir("v10", "train") == tmp_path / "runs" / "v10" / "train"
    assert not config.exists()
    config.mkdir()
    (config / "settings.yaml").write_text(yaml.safe_dump({"runs_dir": str(tmp_path / "elsewhere")}))
    assert get_save_dir("v10", "train", name="exp") == tmp_path / "elsewhere" / "v10" / "exp"
    assert get_save_dir("v10", "train", project=tmp_path, name="exp") == tmp_path / "exp3"
    assert get_save_dir("v10", "train", project=tmp_path, name="exp", exist_ok=True) == tmp_path / "exp"


def test_port_imports_without_jax_flax_or_msgpack(tmp_path):
    """With jax, flax, optax, msgpack and the JAX package made unimportable, the port imports its
    checkpoint modules, saves a model and loads it back, and reads and writes a train state."""
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'lpc_yolo_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from lpc_yolo_tpu_torch import YOLO\n"
        "from lpc_yolo_tpu_torch.engine.trainer import Trainer, host_state\n"
        "from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state\n"
        "from lpc_yolo_tpu_torch.utils.checkpoint import save_checkpoint, load_checkpoint\n"
        "from lpc_yolo_tpu_torch.utils.flax_bridge import train_state_dict, train_state_from_dict\n"
        f"path = {str(tmp_path / 'm.ckpt')!r}\n"
        "y = YOLO(device='cpu', nc=3)\n"
        "y.save(path)\n"
        "z = YOLO(path, device='cpu')\n"
        "a, b = y.model.state_dict(), z.model.state_dict()\n"
        "assert all(torch.equal(a[k], b[k]) for k in a) and z.names == y.names\n"
        "cfg = OptConfig(optimizer='adamw')\n"
        "st = init_train_state(y.model, cfg, 'cpu')\n"
        f"save_checkpoint({str(tmp_path / 's.ckpt')!r}, train_state_dict(st, cfg), {{'epoch': 0}})\n"
        f"tree, meta = load_checkpoint({str(tmp_path / 's.ckpt')!r})\n"
        "train_state_from_dict(z.model, cfg, tree, 'cpu')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'lpc_yolo_tpu')]\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"  # as `one_torch_thread`
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def test_save_checkpoint_is_atomic_and_json(tmp_path):
    """The file layout: 8-byte little-endian meta length, the JSON meta, the msgpack tree; written
    through a .tmp that does not stay behind."""
    path = tmp_path / "w" / "x.ckpt"
    save_checkpoint(path, {"a": np.arange(3, dtype=np.float32)}, {"epoch": 1, "names": {0: "a"}})
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert json.loads(raw[8:8 + n]) == {"epoch": 1, "names": {"0": "a"}}
    tree, meta = load_checkpoint(path)
    np.testing.assert_array_equal(tree["a"], np.arange(3, dtype=np.float32))
    assert sorted(p.name for p in path.parent.iterdir()) == ["x.ckpt"]
