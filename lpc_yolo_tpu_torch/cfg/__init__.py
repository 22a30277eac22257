"""The flag system and the `yolo` command line of the port (counterpart of `lpc_yolo_tpu/cfg/__init__.py`;
reference cfg/__init__.py:99-613).

`default.yaml` is a byte copy of the JAX package's: one flat typed namespace. `get_cfg` merges
overrides into it with `check_dict_alignment` (unknown keys, with fuzzy suggestions) and `check_cfg`
(types), as the JAX functions do. `entrypoint(argv)` parses `yolo [TASK] MODE key=value ...`
(`python -m lpc_yolo_tpu_torch ...`) with the JAX grammar (`merge_equals_args`, `_parse_value`)
and runs the mode on the port's `YOLO`, on the card unless `device=cpu` (an empty `device` means
cuda):

- `train` hands the trainer the JAX mode's keys and every other override the trainer reads; the
  augmentation keys go to the transforms as `hyp`. (The JAX mode passes its fixed list of keys
  only, so it drops mosaic, perspective, copy_paste and the other augmentation keys: ROADMAP
  Queue 3.) An override that nothing of the port's training reads raises NotImplementedError
  naming it.
- `val`, `predict` and `track` pass every override that the facade method takes (`MODE_KEYS`): the
  JAX modes' keys, and `iou`, `batch`, `conf` (0 too) and `max_det`, which the JAX modes drop
  (ROADMAP Queue 3); an override that the mode does not read raises NotImplementedError naming it.
  They print what the JAX modes print.
- `export` exports the model (`format`, `imgsz`, `batch`) and returns the artifact's path; `benchmark` gives the
  format benchmark's rows (`data`, `imgsz`) and prints each, as the JAX modes do. `default.yaml`'s `format:
  tflite` is the TensorFlow family, which is not ported, so `export` without a `format=` raises naming it.
- The special modes: `help`, `version`, `cfg`, `copy-cfg`, `checks` (torch, CUDA, the card and
  nvcc in place of the JAX devices) and `settings` (`settings k=v ...`, `settings reset`: the same
  `settings.yaml` as the JAX CLI writes, `utils/infra.py::SettingsManager`).

`hub`, `login`, `logout` and `explorer` are not ported and raise NotImplementedError naming what is missing.
"""

from __future__ import annotations

import difflib
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Union

import yaml

CFG_PATH = Path(__file__).parent / "default.yaml"
DEFAULT_CFG_DICT: Dict[str, Any] = yaml.safe_load(CFG_PATH.read_text())

# type groups (reference cfg/__init__.py:99-130)
CFG_FLOAT_KEYS = {
    "warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "pose", "kobj",
    "workspace", "batch",
}
CFG_FRACTION_KEYS = {
    "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr",
    "label_smoothing", "hsv_h", "hsv_s", "hsv_v", "translate", "scale", "perspective",
    "flipud", "fliplr", "mosaic", "mixup", "copy_paste", "conf", "iou", "fraction",
    "erasing", "crop_fraction", "bgr",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det",
    "vid_stride", "line_width", "nbs", "save_period", "imgsz", "val_period",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr",
    "resume", "amp", "profile", "val", "save_json", "save_hybrid", "half", "dnn",
    "plots", "show", "save_txt", "save_conf", "save_crop", "save_frames",
    "show_labels", "show_conf", "visualize", "augment", "agnostic_nms",
    "retina_masks", "show_boxes", "keras", "optimize", "int8", "dynamic", "simplify",
    "nms", "multi_scale", "stream_buffer", "pretrained", "overlap_mask",
}

TASKS = {"detect", "segment", "classify", "pose", "obb"}
MODES = {"train", "val", "predict", "export", "track", "benchmark"}

# the keys the JAX train mode passes (its :225-243), then the other Trainer options the port reads when given
TRAIN_KEYS = ("data", "epochs", "imgsz", "workers", "close_mosaic", "resume", "patience", "lr0", "lrf", "save",
              "save_period", "project", "name", "exist_ok")
TRAIN_EXTRA_KEYS = ("momentum", "weight_decay", "warmup_epochs", "seed", "cache", "val")
# what the CLI consumes itself, in every mode
CLI_KEYS = {"task", "mode", "model", "device"}
# the save family that `predict` passes (the JAX mode's), and every key each other mode hands its facade method
SAVE_FLAGS = ("save", "save_txt", "save_conf", "save_crop", "project", "name", "exist_ok")
MODE_KEYS = {
    "predict": {"source", "conf", "iou", "imgsz", "batch", "max_det", "save_dir", *SAVE_FLAGS},
    "val": {"data", "imgsz", "batch", "conf", "iou", "max_det", "workers", "save_json", "save_dir"},
    "track": {"source", "tracker", "conf", "iou", "imgsz", "max_det", "save_dir", *SAVE_FLAGS},
    "export": {"format", "imgsz", "batch"},
    "benchmark": {"data", "imgsz"},
}


def cfg2dict(cfg: Union[str, Path, Dict, SimpleNamespace]) -> Dict:
    if isinstance(cfg, (str, Path)):
        return yaml.safe_load(Path(cfg).read_text())
    if isinstance(cfg, SimpleNamespace):
        return vars(cfg)
    return dict(cfg)


def check_cfg(cfg: Dict, hard: bool = True) -> None:
    """Type-validate config values in place (reference cfg/__init__.py:231-280)."""
    for k, v in list(cfg.items()):
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS and not isinstance(v, (int, float)):
            try:
                cfg[k] = float(v)
            except (ValueError, TypeError):
                _bad(k, v, "int/float", hard)
        elif k in CFG_FRACTION_KEYS:
            try:
                cfg[k] = v = float(v)
            except (ValueError, TypeError):
                _bad(k, v, "float in [0,1]", hard)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"'{k}={v}' must be in [0.0, 1.0]")
        elif k in CFG_INT_KEYS and not isinstance(v, int):
            try:
                cfg[k] = int(v)
            except (ValueError, TypeError):
                _bad(k, v, "int", hard)
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            if str(v).lower() in ("true", "false"):
                cfg[k] = str(v).lower() == "true"
            else:
                _bad(k, v, "bool", hard)


def _bad(k, v, want, hard):
    msg = f"'{k}={v}' has invalid type {type(v).__name__}; expected {want}"
    if hard:
        raise TypeError(msg)
    print(f"WARNING: {msg}")


def check_dict_alignment(base: Dict, custom: Dict) -> None:
    """Reject unknown keys with fuzzy suggestions (reference cfg/__init__.py:302-326)."""
    mismatched = [k for k in custom if k not in base]
    if mismatched:
        msgs = []
        for x in mismatched:
            matches = difflib.get_close_matches(x, base.keys())
            s = f"'{x}' is not a valid key"
            if matches:
                s += f". Did you mean {matches}?"
            msgs.append(s)
        raise SyntaxError("\n".join(msgs))


def get_cfg(cfg: Union[str, Dict, SimpleNamespace] = DEFAULT_CFG_DICT, overrides: Optional[Dict] = None) -> SimpleNamespace:
    """Merge defaults <- overrides with validation; returns a namespace."""
    cfg = cfg2dict(cfg)
    if overrides:
        overrides = cfg2dict(overrides)
        overrides.pop("save_dir", None)
        check_dict_alignment(cfg, overrides)
        cfg = {**cfg, **overrides}
    for k in ("project", "name"):
        if isinstance(cfg.get(k), (int, float)):
            cfg[k] = str(cfg[k])
    check_cfg(cfg)
    return SimpleNamespace(**cfg)


DEFAULT_CFG = SimpleNamespace(**DEFAULT_CFG_DICT)


def merge_equals_args(args: List[str]) -> List[str]:
    """Rejoin tokens the shell split around '=' (reference cfg/__init__.py:327-350):
    ["k", "=", "v"] / ["k=", "v"] / ["k", "=v"] all become ["k=v"]."""
    out: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "=" and out and i + 1 < len(args):
            out[-1] += "=" + args[i + 1]
            i += 2
        elif a.endswith("=") and "=" not in a[:-1] and i + 1 < len(args):
            out.append(a + args[i + 1])
            i += 2
        elif a.startswith("=") and out:
            out[-1] += a
            i += 1
        else:
            out.append(a)
            i += 1
    return out


def _parse_value(v: str) -> Any:
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def _not_ported(what: str) -> None:
    raise NotImplementedError(f"{what} is not ported to the PyTorch package yet")


def entrypoint(argv: Optional[List[str]] = None) -> Any:
    """`yolo [TASK] MODE k=v...` on the port (reference cfg/__init__.py:442-613).

    Examples:
        python -m lpc_yolo_tpu_torch train model=yolov10n.yaml data=data.yaml epochs=10 batch=-1
        python -m lpc_yolo_tpu_torch predict model=yolov10n.yaml source=images/ device=cpu
        python -m lpc_yolo_tpu_torch val model=yolov10n.yaml data=data.yaml
        python -m lpc_yolo_tpu_torch export model=yolov10n.yaml format=onnx imgsz=640
        python -m lpc_yolo_tpu_torch benchmark model=yolov10n.yaml imgsz=640
        python -m lpc_yolo_tpu_torch version | help | cfg | checks | settings
    """
    from .. import __version__

    args = list(argv) if argv is not None else sys.argv[1:]
    if not args:
        print(_usage())
        return None
    special = {
        "help": lambda: print(_usage()),
        "version": lambda: print(__version__),
        "cfg": lambda: print(yaml.safe_dump(DEFAULT_CFG_DICT, sort_keys=False)),
        "copy-cfg": _copy_cfg,
        "checks": lambda: print(_checks()),
        "settings": lambda: print(yaml.safe_dump(dict(_settings()), sort_keys=False)),
    }
    if len(args) == 1 and args[0] in special:
        special[args[0]]()
        return None
    if args[0] == "settings" and len(args) > 1:
        return handle_yolo_settings(args[1:])
    if args[0] in ("login", "logout", "hub"):
        _not_ported(f"`yolo {args[0]}` (Ultralytics HUB)")
    if args[0] == "explorer":
        _not_ported("`yolo explorer` (the dataset explorer)")

    overrides: Dict[str, Any] = {}
    task, mode = None, None
    for a in merge_equals_args(args):
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = _parse_value(v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        else:
            check_dict_alignment({**DEFAULT_CFG_DICT, **{t: None for t in TASKS | MODES}}, {a: ""})
    mode = mode or overrides.pop("mode", None) or "predict"
    task = task or overrides.pop("task", None) or "detect"

    default_models = {
        "detect": "yolov10n.yaml",
        "segment": "yolov8-seg.yaml",
        "classify": "yolov8-cls.yaml",
        "pose": "yolov8-pose.yaml",
        "obb": "yolov8-obb.yaml",
    }
    model_name = overrides.pop("model", None) or default_models[task]
    cfg = get_cfg(DEFAULT_CFG_DICT, {**overrides, "mode": mode, "task": task})
    device = "cuda" if cfg.device in (None, "") else f"cuda:{cfg.device}" if isinstance(cfg.device, int) else str(cfg.device)

    if mode != "train":
        unread = sorted(set(overrides) - MODE_KEYS[mode] - CLI_KEYS)
        if unread:
            _not_ported(f"`{mode}` with {unread} (read by no part of the mode)")

    from ..engine.model import YOLO

    model = YOLO(model_name, device=device)

    if mode == "train":
        from ..data.augment import DEFAULT_HYP

        hyp = {k: getattr(cfg, k) for k in overrides if k in DEFAULT_HYP}
        unread = sorted(set(overrides) - set(TRAIN_KEYS) - set(TRAIN_EXTRA_KEYS) - CLI_KEYS - set(hyp)
                        - {"batch", "optimizer"})
        if unread:
            _not_ported(f"training with {unread} (read by no part of the trainer)")
        kw = {k: getattr(cfg, k) for k in TRAIN_KEYS}
        kw.update({k: getattr(cfg, k) for k in TRAIN_EXTRA_KEYS if k in overrides})
        return model.train(batch=int(cfg.batch), optimizer=str(cfg.optimizer).lower(), hyp=hyp or None,
                           device=device, **kw)
    # the keys given, as the facade method takes them; save_dir is not a flag (get_cfg drops it) but they take it
    given = {k: overrides[k] if k == "save_dir" else getattr(cfg, k) for k in overrides
             if k in MODE_KEYS[mode] - {"data", "source", "tracker"} and overrides[k] is not None}
    if mode == "val":
        kw = {"imgsz": cfg.imgsz, "batch": int(cfg.batch), "save_json": cfg.save_json, **given}
        kw["batch"] = int(kw["batch"])
        results = model.val(data=cfg.data, device=device, **kw)
        for k, v in results.items():
            print(f"{k}: {v:.5f}")
        return results
    if mode == "predict":
        if not cfg.source:
            raise ValueError("predict needs source=<image, directory, glob or video>")
        # CLI runs save their results by default (reference Model.predict: save=is_cli)
        kw = {"imgsz": cfg.imgsz, "max_det": cfg.max_det, **{k: getattr(cfg, k) for k in SAVE_FLAGS}, **given}
        kw["conf"] = 0.25 if cfg.conf is None else cfg.conf
        if "batch" in kw:
            kw["batch"] = int(kw["batch"])
        results = model.predict(cfg.source, device=device, **kw)
        for r in results:
            print(f"{r.path}: {len(r)} detections")
        return results
    if mode == "export":
        return model.export(format=cfg.format, imgsz=cfg.imgsz, batch=int(cfg.batch) if "batch" in given else 1)
    if mode == "benchmark":
        rows = model.benchmark(data=cfg.data, imgsz=cfg.imgsz, verbose=False)
        for row in rows:
            print(row)
        return rows
    if mode == "track":
        import numpy as np

        kw = {"imgsz": cfg.imgsz, "max_det": cfg.max_det, **given}
        kw["conf"] = 0.1 if cfg.conf is None else cfg.conf
        results = model.track(cfg.source, tracker=cfg.tracker, device=device, **kw)
        for r in results:
            ids = r.boxes.id if r.boxes is not None and r.boxes.id is not None else []
            print(f"{r.path}: {len(r)} tracks {[int(i) for i in np.asarray(ids).tolist()] if len(ids) else []}")
        return results


def _settings():
    from ..utils.infra import SettingsManager

    return SettingsManager()


def handle_yolo_settings(args: List[str]) -> None:
    """`yolo settings k=v ...` / `yolo settings reset` (reference cfg/__init__.py:379)."""
    s = _settings()
    if args and args[0] == "reset":
        s.reset()
        print("settings reset")
        return
    updates = {}
    for a in merge_equals_args(args):
        if "=" in a:
            k, v = a.split("=", 1)
            check_dict_alignment(dict(s), {k: v})
            updates[k] = _parse_value(v)
    if updates:
        s.update(**updates)
    print(yaml.safe_dump(dict(s), sort_keys=False))


def _copy_cfg() -> None:
    """Copy default.yaml into the working directory for editing (reference copy_default_cfg)."""
    import shutil

    dst = Path.cwd() / (CFG_PATH.stem + "_copy.yaml")
    shutil.copy2(CFG_PATH, dst)
    print(f"{CFG_PATH} copied to {dst}")


def _usage() -> str:
    return (
        "usage: yolo TASK MODE ARGS\n"
        "  TASK in {detect,segment,classify,pose,obb}\n"
        "  MODE in {train,val,predict,export,track,benchmark}\n"
        "  e.g. yolo detect train model=yolov10n.yaml data=data.yaml epochs=100\n"
        "       yolo predict model=yolov10n.yaml source=image.jpg\n"
        "       yolo track model=yolov10n.yaml source=video.mp4 tracker=botsort.yaml\n"
        "  special: yolo help | version | cfg | copy-cfg | checks |\n"
        "           yolo settings [k=v ...|reset] | yolo login KEY | yolo logout"
    )


def _checks() -> str:
    """torch, its CUDA, the card and nvcc, in place of the JAX devices."""
    import torch

    from ..ops._build import _nvcc

    card = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none"
    try:
        nvcc = _nvcc()
    except RuntimeError:
        nvcc = "not found"
    return f"torch {torch.__version__}, CUDA {torch.version.cuda}, device: {card}, nvcc: {nvcc}"
