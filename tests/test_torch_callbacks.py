"""The trainer's remainder against the JAX package, on the CPU: the callback bus and its sinks, the five
training events, autobatch and the AugmentedCache window.

- `CallbackRegistry` (`utils/callbacks.py`): the JAX and the port's registries, given the same fake trainer,
  attach the same sinks and write the same files (MLflow file store, DVCLive, events.jsonl), timestamps and
  run ids masked.
- A one-epoch `train(data=...)` of a narrow LPC-YOLO fires the JAX trainer's events in the JAX order (read from
  the JAX trainer's source), the facade's hooks first; `add_callback`, `clear_callback` and `reset_callbacks`
  act as the JAX facade's.
- `autobatch` with the device's memory and the step's peak faked alike in both packages picks the same batch
  and prints the same lines.
- `AugmentedCache` with `refresh=False` over the JAX loader and over the port's serves the same batches in the
  same order (the port's plans rendered on the CPU equal the JAX images bit for bit), through `invalidate`, with
  the same `echo_factor`; `train(cache_augmented=2)` runs and reports its echo factor.
"""

import contextlib
import inspect
import io
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from lpc_yolo_tpu.data import DataLoader as JaxDataLoader
from lpc_yolo_tpu.data import TrainTransforms as JaxTrainTransforms
from lpc_yolo_tpu.data import YOLODataset as JaxDataset
from lpc_yolo_tpu.data.shard_cache import AugmentedCache as JaxAugmentedCache
from lpc_yolo_tpu.engine.model import YOLO as JaxYOLO
from lpc_yolo_tpu.engine.trainer import Trainer as JaxTrainer
from lpc_yolo_tpu.utils import autobatch as jax_autobatch
from lpc_yolo_tpu.utils import callbacks as jax_callbacks

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch.data import DataLoader, TrainTransforms, YOLODataset, check_det_dataset, make_synthetic_dataset
from lpc_yolo_tpu_torch.data import render
from lpc_yolo_tpu_torch.data.shard_cache import AugmentedCache
from lpc_yolo_tpu_torch.utils import autobatch as port_autobatch
from lpc_yolo_tpu_torch.utils import callbacks as port_callbacks

ROOT = Path(__file__).resolve().parents[1]
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_events_and_registry_match_jax():
    assert port_callbacks.EVENTS == jax_callbacks.EVENTS
    assert dict(port_callbacks.get_default_callbacks()) == dict(jax_callbacks.get_default_callbacks())
    for mod in (port_callbacks, jax_callbacks):
        reg, seen = mod.CallbackRegistry(), []
        reg.add("on_train_start", lambda t: seen.append(("a", t)))
        reg.add("on_train_start", lambda t: seen.append(("b", t)))
        reg.run("on_train_start", 1)
        reg.run("on_val_end", 2)
        assert seen == [("a", 1), ("b", 1)]
        with pytest.raises(ValueError, match="unknown callback event"):
            reg.add("on_epoch", print)


def masked_tree(root: Path) -> dict:
    """Every file under root by relative path (run ids as <id>), its text with timestamps, run ids and the root
    masked; TensorBoard's binary event files by name only."""
    out = {}
    run_ids = {p.name for p in (root / "mlruns" / "0").iterdir() if p.is_dir()} if (root / "mlruns").exists() else set()
    for f in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(f.relative_to(root))
        for rid in run_ids:
            rel = rel.replace(rid, "<id>")
        if "tfevents" in rel:
            out["tfevents"] = True
            continue
        text = f.read_text().replace(str(root), "<root>")
        for rid in run_ids:
            text = text.replace(rid, "<id>")
        text = re.sub(r"(start_time|end_time): \d+", r"\1: <t>", text)
        if "/metrics/" in rel and "dvclive" not in rel:
            text = re.sub(r"^\d+ ", "<t> ", text, flags=re.M)
        if rel == "events.jsonl":
            text = "".join(json.dumps({**json.loads(line), "time": "<t>"}) + "\n" for line in text.splitlines())
        out[rel] = text
    return out


def test_sinks_write_what_the_jax_sinks_write(tmp_path):
    """Both registries' integration sinks, driven by the same fake trainer through two epochs and the end of
    training, write the same files; the attached lists are equal."""
    trees = []
    for name, mod in (("port", port_callbacks), ("jax", jax_callbacks)):
        save_dir = tmp_path / name
        reg = mod.CallbackRegistry()
        attached = reg.add_integration_callbacks(save_dir=save_dir)
        trainer = SimpleNamespace(save_dir=save_dir, epoch=0, last_metrics={})
        for epoch in range(2):
            trainer.epoch = epoch
            trainer.last_metrics = {"epoch": epoch, "train/box_om": 1.5 - epoch, "metrics/mAP50(B)": 0.25 * epoch,
                                    "lr": 0.001, "note": "not a number"}
            reg.run("on_fit_epoch_end", trainer)
        reg.run("on_train_end", trainer)
        trees.append((attached, masked_tree(save_dir)))
    assert trees[0][0] == trees[1][0] and {"mlflow-filestore", "dvclive", "jsonl"} <= set(trees[0][0])
    assert trees[0][1] == trees[1][1]
    assert "events.jsonl" in trees[0][1] and "dvclive/metrics.json" in trees[0][1]


def jax_event_order() -> list:
    """The events the JAX trainer fires in one epoch, in the order its source runs them."""
    return re.findall(r'self\.callbacks\.run\("(\w+)"', inspect.getsource(JaxTrainer.train))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cb")
    d = yaml.safe_load(PORT_YAML.read_text())
    d.update(nc=3, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    (tmp / "narrow.yaml").write_text(yaml.safe_dump(d))
    data = make_synthetic_dataset(tmp / "ds", n_train=8, n_val=2, max_boxes=4, seed=1, imgsz=S)
    return {"tmp": tmp, "model": str(tmp / "narrow.yaml"), "data": data}


def test_training_fires_the_jax_events_in_the_jax_order(env):
    """A one-epoch train(data=...): the facade's hooks see on_train_start, on_train_epoch_start, on_model_save,
    on_fit_epoch_end and on_train_end in the JAX trainer's order, the trainer's epoch and metrics row with them;
    the sinks' files are in save_dir."""
    order = jax_event_order()
    assert order == ["on_train_start", "on_train_epoch_start", "on_model_save", "on_fit_epoch_end", "on_train_end"]
    yolo, seen = YOLO(env["model"], device="cpu"), []
    for event in port_callbacks.EVENTS:
        yolo.add_callback(event, lambda t, e=event: seen.append((e, t.epoch, dict(t.last_metrics))))
    save_dir = env["tmp"] / "events"
    yolo.train(data=env["data"], epochs=1, batch=4, imgsz=S, workers=2, save_dir=save_dir, device="cpu")
    assert [e for e, _, _ in seen] == order
    fit = seen[3][2]
    assert fit["epoch"] == 0 and "train/box_om" in fit and "metrics/mAP50(B)" in fit
    rows = [json.loads(line) for line in (save_dir / "events.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["epoch"] == 0
    assert (save_dir / "dvclive" / "metrics.json").exists() and (save_dir / "mlruns" / "0" / "meta.yaml").exists()


def test_facade_callback_hooks_match_jax():
    """add_callback, clear_callback and reset_callbacks leave the same dicts on both facades."""
    port, ref = YOLO.__new__(YOLO), JaxYOLO.__new__(JaxYOLO)
    f, g = print, repr
    for y in (port, ref):
        y.callbacks = {}
        y.add_callback("on_train_start", f)
        y.add_callback("on_train_start", g)
        y.add_callback("on_train_end", f)
    assert port.callbacks == ref.callbacks == {"on_train_start": [f, g], "on_train_end": [f]}
    for y in (port, ref):
        y.clear_callback("on_train_start")
    assert port.callbacks == ref.callbacks == {"on_train_start": [], "on_train_end": [f]}
    for y in (port, ref):
        y.reset_callbacks()
    assert port.callbacks == ref.callbacks == {}


PEAKS = {"fits_all": {}, "tight": {1: 100, 2: 500, 4: 601}, "nothing_fits": {1: 700},
         "oom_at_16": {16: -1}, "oom_at_1": {1: -1}}


@pytest.mark.parametrize("case", list(PEAKS), ids=list(PEAKS))
def test_autobatch_matches_jax(case, monkeypatch):
    """autobatch's search with the device's memory (1000 bytes) and each probe's peak (a table, 37 b bytes
    elsewhere; -1 for an out-of-memory probe) faked alike: the same batch and the same printed lines."""
    peaks = PEAKS[case]

    def fake(fn, *args):
        b = fn(*args)
        return peaks.get(b, 37 * b)

    def make_fn(b):
        return (lambda n: n), (b,)

    got = []
    for mod, reader in ((port_autobatch, "step_memory_bytes"), (jax_autobatch, "program_memory_bytes")):
        monkeypatch.setattr(mod, "device_memory_bytes", lambda device=None: 1000)
        monkeypatch.setattr(mod, reader, fake)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            best = mod.autobatch(make_fn, max_batch=128)
        got.append((best, buf.getvalue()))
    assert got[0] == got[1]
    probes = []
    port_autobatch.autobatch(make_fn, verbose=False, probes=probes)
    assert [b for b, _, _ in probes] == [int(line.split("=")[1].split()[0]) for line in got[0][1].splitlines()]


def test_autobatch_reads_the_card_only():
    with pytest.raises(ValueError, match="card's memory"):
        port_autobatch.device_memory_bytes("cpu")


@pytest.fixture(scope="module")
def loaders(env):
    info = check_det_dataset(env["data"])
    port_ds, jax_ds = YOLODataset(info["train"], cache=False), JaxDataset(info["train"], cache=False)
    hyp = {"mixup": 0.5}

    def make():
        port_tt, jax_tt = TrainTransforms(S, hyp, max_gt=24), JaxTrainTransforms(S, hyp, max_gt=24)
        port = DataLoader(port_ds, port_tt.plan, batch_size=2, workers=2, shuffle=True, seed=4, infinite=True)
        ref = JaxDataLoader(jax_ds, jax_tt, batch_size=2, workers=2, shuffle=True, seed=4, infinite=True)
        return (port, port_tt), (ref, jax_tt)

    return make


def test_augmented_cache_serves_what_the_jax_cache_serves(loaders):
    """refresh=False, capacity 3: two passes of the window, then close_mosaic + invalidate and two more; every
    served batch equal (labels exactly, the port's plans rendered on the CPU = the JAX images), the same
    echo factor."""
    (port_loader, port_tt), (jax_loader, jax_tt) = loaders()
    port = AugmentedCache(port_loader, capacity=3, refresh=False, seed=11)
    ref = JaxAugmentedCache(jax_loader, capacity=3, refresh=False, seed=11)
    pi, ji = iter(port), iter(ref)
    for n in range(12):
        if n == 6:
            port_tt.close_mosaic()
            jax_tt.close_mosaic()
            port.invalidate()
            ref.invalidate()
        a, b = next(pi), next(ji)
        for k in ("cls", "bboxes", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {n} {k}")
        np.testing.assert_array_equal(render(a["plan"], a["sources"], torch.device("cpu")).numpy(), b["img"],
                                      err_msg=f"batch {n} image")
        if n >= 6:
            assert all(len(p.canvas.tiles) == 1 for p in a["plan"])  # letterboxed after close_mosaic
    assert (port.served, port.refreshed) == (ref.served, ref.refreshed) == (12, 3)
    assert port.echo_factor() == ref.echo_factor() == 2.0
    assert len(port) == len(ref) == 4
    port.stop()
    ref.stop()


def test_augmented_cache_refresh_thread_stops(loaders):
    (port_loader, _), _ = loaders()
    cache = AugmentedCache(port_loader, capacity=2, refresh=True, seed=0)
    it = iter(cache)
    for _ in range(3):
        assert next(it)["cls"].shape == (2, 24)
    cache.stop()
    assert not cache._thread.is_alive()
    assert cache.echo_factor() == cache.served / (2 + cache.refreshed)


def test_train_with_cache_augmented(env, capsys):
    """train(cache_augmented=2) for two epochs with close_mosaic=1: finite losses, the window invalidated at the
    close_mosaic epoch, and the echo factor printed."""
    yolo = YOLO(env["model"], device="cpu")
    yolo.train(data=env["data"], epochs=2, batch=4, imgsz=S, workers=2, close_mosaic=1, cache_augmented=2,
               save_dir=env["tmp"] / "cached", device="cpu", val=False)
    tr = yolo.trainer
    assert tr.aug_cache is not None and tr.aug_cache.capacity == 2 and tr.aug_cache.served == 4
    assert tr.aug_cache.refreshed >= 2 and not tr.aug_cache._thread.is_alive()
    assert all(np.isfinite(h["loss"]) and not h["skipped"] for h in tr.history)
    assert "aug cache: echo factor" in capsys.readouterr().out
