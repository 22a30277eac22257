"""The port's `yolo` command line (`lpc_yolo_tpu_torch/cfg/__init__.py`) against the JAX package's, on the CPU.

The flag system (`DEFAULT_CFG_DICT`, `merge_equals_args`, `_parse_value`, `get_cfg`, `check_cfg`,
`check_dict_alignment`) is held to the JAX functions on the same argument lists: the same values and the
same errors. The special modes print what the JAX ones print and `settings` writes the same file. The
modes run the port's `YOLO` on a narrow LPC-YOLO (the YAML's layers at widths 8-32, nc 3) at imgsz 64: each
equals the facade call it stands for, which the other test files hold to the JAX package. The CLI's
`train` at `batch=-1` (autobatch, with the card's memory faked) gives the run of `train(batch=<chosen>)`
bit for bit. The JAX `train` mode drops the augmentation keys, and its `predict`, `val` and `track` modes `iou`,
`batch`, `conf` and `max_det` (ROADMAP Queue 3); the port passes them on and refuses a key that no part of a
mode reads.
"""

import contextlib
import csv
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import lpc_yolo_tpu
from lpc_yolo_tpu import cfg as jcfg
from lpc_yolo_tpu.utils.infra import SettingsManager as JaxSettings

from lpc_yolo_tpu_torch import YOLO
from lpc_yolo_tpu_torch import cfg as tcfg
from lpc_yolo_tpu_torch.data import make_synthetic_dataset
from lpc_yolo_tpu_torch.utils import autobatch as port_autobatch

ROOT = Path(__file__).resolve().parents[1]
PORT_YAML = ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def printed(fn, *args):
    """(fn's return value, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def test_default_config_is_the_jax_one():
    assert (ROOT / "lpc_yolo_tpu_torch" / "cfg" / "default.yaml").read_bytes() == \
        (ROOT / "lpc_yolo_tpu" / "cfg" / "default.yaml").read_bytes()
    assert tcfg.DEFAULT_CFG_DICT == jcfg.DEFAULT_CFG_DICT
    assert (tcfg.TASKS, tcfg.MODES) == (jcfg.TASKS, jcfg.MODES)
    for group in ("CFG_FLOAT_KEYS", "CFG_FRACTION_KEYS", "CFG_INT_KEYS", "CFG_BOOL_KEYS"):
        assert getattr(tcfg, group) == getattr(jcfg, group), group


ARGVS = [["train", "model=a.yaml", "epochs", "=", "3"], ["imgsz=", "320", "batch", "=8"],
         ["lr0", "=", "0.02", "name=", "x"], ["a=b=c", "k="], ["=", "x", "y"], ["predict", "source=x.png", "=1"],
         ["detect", "val", "iou=", "0.5", "conf", "=", "0.1", "half=False"]]
VALUES = ["3", "3.5", "-1", "1e-3", "true", "False", "None", "null", "", "[1, 2]", "abc", "a: b", "{x: 1}", ": bad",
          "'quoted'", "yolov8n.yaml", "0,1"]


@pytest.mark.parametrize("argv", ARGVS)
def test_merge_equals_args_matches_jax(argv):
    assert tcfg.merge_equals_args(list(argv)) == jcfg.merge_equals_args(list(argv))


def test_parse_value_matches_jax():
    for v in VALUES:
        assert tcfg._parse_value(v) == jcfg._parse_value(v), v


GOOD = [None, {"epochs": "5", "lr0": "0.02", "save": "False", "batch": "-1", "name": 7, "mosaic": 1},
        {"imgsz": 320.0, "fliplr": 0, "project": 3.5, "save_dir": "x", "copy_paste": "0.5"}]
BAD = [{"epochs": "x"}, {"lr0": 2.0}, {"epoch": 3}, {"save": "maybe"}, {"fliplr": "left"}, {"batchsize": 8, "lr": 1}]


def test_get_cfg_and_its_errors_match_jax():
    for ov in GOOD:
        assert vars(tcfg.get_cfg(tcfg.DEFAULT_CFG_DICT, dict(ov) if ov else None)) == \
            vars(jcfg.get_cfg(jcfg.DEFAULT_CFG_DICT, dict(ov) if ov else None))
    for ov in BAD:
        errors = []
        for mod in (tcfg, jcfg):
            with pytest.raises(Exception) as e:
                mod.get_cfg(mod.DEFAULT_CFG_DICT, dict(ov))
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1], ov
    errors = []
    for mod in (tcfg, jcfg):
        with pytest.raises(SyntaxError) as e:
            mod.entrypoint(["trian", "model=x.yaml"])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "Did you mean" in errors[0]


@pytest.mark.parametrize("mode", ["cfg", "help", "version"])
def test_special_modes_print_what_jax_prints(mode):
    port, jax_ = printed(tcfg.entrypoint, [mode])[1], printed(jcfg.entrypoint, [mode])[1]
    assert port == jax_
    assert printed(tcfg.entrypoint, [])[1] == printed(jcfg.entrypoint, [])[1]


def test_copy_cfg_and_checks(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    printed(tcfg.entrypoint, ["copy-cfg"])
    assert (tmp_path / "default_copy.yaml").read_bytes() == (ROOT / "lpc_yolo_tpu" / "cfg" / "default.yaml").read_bytes()
    out = printed(tcfg.entrypoint, ["checks"])[1]
    assert out.startswith(f"torch {torch.__version__}, CUDA ") and "nvcc:" in out


def test_settings_files_match_jax(tmp_path, monkeypatch):
    """`settings`, `settings k=v ...` and `settings reset` leave byte-identical settings.yaml files, each
    package under a settings directory of its own, and print the same text."""
    port_file, jax_file = tmp_path / "port" / "settings.yaml", tmp_path / "jax" / "settings.yaml"
    monkeypatch.setenv("LPC_YOLO_CONFIG_DIR", str(port_file.parent))
    monkeypatch.setattr(lpc_yolo_tpu, "settings", JaxSettings(jax_file), raising=False)
    steps = [["settings"], ["settings", "runs_dir=", str(tmp_path / "r"), "sync=True", "api_key", "=", "abc"],
             ["settings", "tensorboard=False"], ["settings", "reset"], ["settings", "weights_dir=w"]]
    for argv in steps:
        port, jax_ = printed(tcfg.entrypoint, argv)[1], printed(jcfg.entrypoint, argv)[1]
        assert port == jax_, argv
        assert port_file.read_bytes() == jax_file.read_bytes(), argv
    assert yaml.safe_load(port_file.read_text())["weights_dir"] == "w"
    for mod in (tcfg, jcfg):
        with pytest.raises(SyntaxError, match="runs_di"):
            mod.entrypoint(["settings", "runs_di=x"])


def test_modes_not_ported_raise(tmp_path, monkeypatch):
    """`login`, `logout`, `hub` and `explorer` raise; `export` runs (`test_export_and_benchmark_modes_equal_the_facade`)
    but refuses the TensorFlow family, default.yaml's `format: tflite` among it, and a key it does not read."""
    monkeypatch.chdir(tmp_path)
    for argv in (["export", f"model={PORT_YAML}", "device=cpu"], ["detect", "export", "format=tflite", "device=cpu",
                 f"model={PORT_YAML}"], ["login", "key"], ["logout"], ["hub", "login"], ["explorer", "data=x.yaml"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            tcfg.entrypoint(argv)
    with pytest.raises(NotImplementedError, match="opset"):
        tcfg.entrypoint(["export", "model=x.yaml", "format=onnx", "opset=12", "device=cpu"])
    assert not (tmp_path / "runs").exists()


class FakeYOLO:
    """Records how a package's CLI builds the facade and what it hands `train`."""

    calls = []

    def __init__(self, model, **kw):
        self.calls.append(("init", str(model), kw))

    def train(self, **kw):
        self.calls.append(("train", kw))
        return {}


def test_train_mode_passes_the_hyp_keys_and_jax_drops_them(monkeypatch):
    """The JAX train mode hands its trainer a fixed list of keys (`lpc_yolo_tpu/cfg/__init__.py:225-243`):
    mosaic, perspective and copy_paste given on the command line never reach its transforms (ROADMAP Queue 3).
    The port passes them as `hyp`, with every other trainer option given; a key that nothing of its
    training reads raises."""
    import lpc_yolo_tpu.engine.model as jax_model
    import lpc_yolo_tpu_torch.engine.model as port_model

    argv = ["train", "model=x.yaml", "data=d.yaml", "mosaic=0.0", "perspective=0.001", "copy_paste=0.5", "seed=3",
            "device=cpu"]
    for mod, module in ((jcfg, jax_model), (tcfg, port_model)):
        monkeypatch.setattr(module, "YOLO", FakeYOLO)
        FakeYOLO.calls = []
        mod.entrypoint(list(argv))
        (_, name, init_kw), (_, train_kw) = FakeYOLO.calls
        assert name == "x.yaml"
        if mod is jcfg:
            assert "hyp" not in train_kw and "seed" not in train_kw
            assert not {"mosaic", "perspective", "copy_paste"} & set(train_kw)
        else:
            assert init_kw == {"device": "cpu"} and train_kw["device"] == "cpu"
            assert train_kw["hyp"] == {"mosaic": 0.0, "perspective": 0.001, "copy_paste": 0.5}
            assert train_kw["seed"] == 3 and train_kw["batch"] == 16 and train_kw["optimizer"] == "auto"
    with pytest.raises(NotImplementedError, match="erasing"):
        tcfg.entrypoint(["train", "model=x.yaml", "data=d.yaml", "erasing=0.2", "device=cpu"])


class RecordingYOLO(FakeYOLO):
    """Records what each mode hands the facade method it calls."""

    def predict(self, source, **kw):
        self.calls.append(("predict", source, kw))
        return []

    def val(self, **kw):
        self.calls.append(("val", kw))
        return {}

    def track(self, source, **kw):
        self.calls.append(("track", source, kw))
        return []


def test_predict_val_track_pass_every_key_and_refuse_an_unread_one(monkeypatch):
    """`iou=`, `batch=`, `conf=0` and `max_det=` reach `YOLO.predict`, `.val` and `.track` (the JAX modes drop them,
    and turn conf=0 into 0.25 or 0.1: ROADMAP Queue 3); a key that no part of the mode reads raises, naming it,
    before any model is built."""
    import lpc_yolo_tpu_torch.engine.model as port_model

    monkeypatch.setattr(port_model, "YOLO", RecordingYOLO)
    RecordingYOLO.calls = []
    tcfg.entrypoint(["predict", "model=x.pt", "source=s", "iou=0.5", "batch=4", "conf=0", "max_det=7", "save=False",
                     "device=cpu"])
    (_, name, _), (_, source, kw) = RecordingYOLO.calls
    assert (name, source) == ("x.pt", "s")
    assert (kw["iou"], kw["batch"], kw["conf"], kw["max_det"], kw["save"]) == (0.5, 4, 0.0, 7, False)
    RecordingYOLO.calls = []
    tcfg.entrypoint(["val", "model=x.yaml", "data=d.yaml", "conf=0", "iou=0.6", "max_det=9", "batch=2", "workers=1",
                     "device=cpu"])
    (_, kw), = RecordingYOLO.calls[1:]
    assert kw["data"] == "d.yaml" and kw["device"] == "cpu"
    assert (kw["conf"], kw["iou"], kw["max_det"], kw["batch"], kw["workers"]) == (0.0, 0.6, 9, 2, 1)
    RecordingYOLO.calls = []
    tcfg.entrypoint(["track", "model=x.yaml", "source=s", "iou=0.4", "conf=0", "max_det=5", "device=cpu"])
    (_, _, kw), = RecordingYOLO.calls[1:]
    assert (kw["iou"], kw["conf"], kw["max_det"], kw["tracker"]) == (0.4, 0.0, 5, "bytetrack.yaml")
    for argv, key in ((["predict", "source=s", "half=False"], "half"), (["val", "data=d.yaml", "vid_stride=2"],
                      "vid_stride"), (["track", "source=s", "batch=2"], "batch")):
        RecordingYOLO.calls = []
        with pytest.raises(NotImplementedError, match=key):
            tcfg.entrypoint([*argv, "model=x.yaml", "device=cpu"])
        assert RecordingYOLO.calls == []


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A working directory with a narrow LPC-YOLO YAML (nc 3) and a synthetic dataset of 8 + 4 frames, its
    runs root ./runs (an empty settings directory)."""
    tmp = tmp_path_factory.mktemp("cli")
    d = yaml.safe_load(PORT_YAML.read_text())
    d.update(nc=3, scales={"t": [0.1, 0.0625, 512]}, scale="t")
    (tmp / "narrow.yaml").write_text(yaml.safe_dump(d))
    data = make_synthetic_dataset(tmp / "ds", n_train=8, n_val=4, max_boxes=4, seed=1, imgsz=S)
    cwd, config = os.getcwd(), os.environ.get("LPC_YOLO_CONFIG_DIR")
    os.chdir(tmp)
    os.environ["LPC_YOLO_CONFIG_DIR"] = str(tmp / "cfg")
    yield {"tmp": tmp, "model": str(tmp / "narrow.yaml"), "data": data, "src": str(tmp / "ds" / "images" / "val")}
    os.chdir(cwd)
    if config is None:
        os.environ.pop("LPC_YOLO_CONFIG_DIR", None)
    else:
        os.environ["LPC_YOLO_CONFIG_DIR"] = config


def test_predict_and_track_modes_equal_the_facade(cli_env):
    e = cli_env
    results, out = printed(tcfg.entrypoint, ["predict", f"model={e['model']}", f"source={e['src']}", f"imgsz={S}",
                                             "save=False", "device=cpu"])
    ref = YOLO(e["model"], device="cpu").predict(e["src"], conf=0.25, imgsz=S, max_det=300)
    assert len(results) == len(ref) == 4
    for a, b in zip(results, ref):
        assert a.path == b.path
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    assert out.splitlines() == [f"{r.path}: {len(r)} detections" for r in ref]
    tracked, out = printed(tcfg.entrypoint, ["track", f"model={e['model']}", f"source={e['src']}", f"imgsz={S}",
                                             "device=cpu"])
    ref = YOLO(e["model"], device="cpu").track(e["src"], conf=0.1, imgsz=S, max_det=300)
    for a, b in zip(tracked, ref):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    assert len(out.splitlines()) == 4 and all(" tracks [" in line for line in out.splitlines())


def test_val_mode_equals_the_facade(cli_env):
    e = cli_env
    results, out = printed(tcfg.entrypoint, ["val", f"model={e['model']}", f"data={e['data']}", f"imgsz={S}",
                                             "batch=4", "device=cpu"])
    ref = YOLO(e["model"], device="cpu").val(data=e["data"], imgsz=S, batch=4, save_json=False)
    assert results == ref
    assert out.splitlines() == [f"{k}: {v:.5f}" for k, v in ref.items()]


def test_train_mode_with_autobatch_equals_train_at_the_chosen_batch(cli_env, monkeypatch):
    """`train ... batch=-1` with the card's memory faked (1000 bytes, a step of batch b "peaking" at 100 b: the
    fake runs every probe step for real, on the CPU) picks batch 4, and its run equals `YOLO.train(batch=4)`
    with the same hyp bit for bit: the same last.ckpt bytes and the same losses, learning rates and metrics
    in results.csv."""
    e = cli_env
    probes = []

    def fake_step_memory(fn, *args):
        fn(*args)
        probes.append(len(probes))
        return 100 * 2 ** (len(probes) - 1)

    monkeypatch.setattr(port_autobatch, "device_memory_bytes", lambda device=None: 1000)
    monkeypatch.setattr(port_autobatch, "step_memory_bytes", fake_step_memory)
    hyp = {"perspective": 0.0005, "copy_paste": 0.5}
    _, out = printed(tcfg.entrypoint, ["train", f"model={e['model']}", f"data={e['data']}", "batch=-1", "epochs=1",
                                       f"imgsz={S}", "perspective=0.0005", "copy_paste=0.5", "workers=2",
                                       "project=cli", "name=auto", "device=cpu"])
    assert "autobatch: using batch=4" in out and len(probes) == 4
    ref = YOLO(e["model"], device="cpu")
    ref.train(data=e["data"], batch=4, epochs=1, imgsz=S, hyp=hyp, workers=2, project="cli", name="fixed",
              device="cpu")
    assert ref.trainer.batch == 4
    run_a, run_b = e["tmp"] / "cli" / "auto", e["tmp"] / "cli" / "fixed"
    assert (run_a / "weights" / "last.ckpt").read_bytes() == (run_b / "weights" / "last.ckpt").read_bytes()
    timing = ("time_s", "input_wait_frac", "render_frac")
    rows = [[{k: v for k, v in row.items() if k not in timing} for row in csv.DictReader((r / "results.csv").open())]
            for r in (run_a, run_b)]
    assert rows[0] == rows[1] and len(rows[0]) == 1


def test_export_and_benchmark_modes_equal_the_facade(cli_env):
    """`export` returns the artifact's path; `benchmark` prints one row a format (the JAX keys), ckpt, onnx and
    torchscript "ok" (onnx noting that cv2.dnn ran it on the CPU) with their sizes (ms/img is a card number: not measured here), the formats the port does
    not write "skipped" with their reason, and with `data` the ckpt row's mAP50-95 from `YOLO.val`. Its ONNX
    artifact (`YOLO.export`'s, at the same size) is the export mode's, byte for byte."""
    e = cli_env
    tiny = e["tmp"] / "tiny.yaml"  # five convs and a v10Detect head: a graph that exports in a second
    tiny.write_text(yaml.safe_dump({"nc": 3, "backbone": [[-1, 1, "Conv", [c, 3, 2]] for c in (8, 16, 16, 16, 16)],
                                    "head": [[[2, 3, 4], 1, "v10Detect", ["nc"]]]}))
    path = tcfg.entrypoint(["export", f"model={tiny}", "format=onnx", f"imgsz={S}", "device=cpu"])
    assert Path(path) == Path("runs/export/tiny.onnx") and Path(path + ".json").exists()
    rows, out = printed(tcfg.entrypoint, ["benchmark", f"model={tiny}", f"data={e['data']}", f"imgsz={S}",
                                          "device=cpu"])
    assert out.splitlines() == [str(r) for r in rows]
    assert [r["format"] for r in rows] == ["ckpt", "stablehlo", "saved_model", "tflite", "tflite-int8", "onnx",
                                           "torchscript", "pb"]
    for r in rows:
        assert list(r) == ["format", "status", "size_mb", "ms/img", "mAP50-95"] and r["ms/img"] is None
        written = r["format"] in ("ckpt", "onnx", "torchscript")
        ok = "ok (cv2.dnn on the CPU)" if r["format"] == "onnx" else "ok"
        assert r["status"] == ok if written else r["status"].startswith("skipped: export format"), r
        assert (r["size_mb"] is not None) == written
    mAP = YOLO(str(tiny), device="cpu").val(data=e["data"], imgsz=S)["metrics/mAP50-95(B)"]
    assert rows[0]["mAP50-95"] == round(mAP, 4)
    assert Path(path).read_bytes() == Path("runs/benchmark/tiny.onnx").read_bytes()


def test_python_m_runs_the_cli():
    out = subprocess.run([sys.executable, "-m", "lpc_yolo_tpu_torch", "version"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == lpc_yolo_tpu.__version__
