"""Run directories and the user settings (counterpart of `lpc_yolo_tpu/utils/infra.py:65-135`:
`SettingsManager`, `increment_path`, `get_save_dir`).

The runs root is the `runs_dir` of the JAX package's settings file
(`$LPC_YOLO_CONFIG_DIR/settings.yaml`, by default
`~/.config/lpc_yolo_tpu/settings.yaml`) when that file exists and names one,
else `./runs`, as the JAX package's default. Training, validation and
prediction only read the file; `SettingsManager` (the CLI's `settings` mode)
writes it, byte for byte as the JAX one does.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import yaml


def settings_file() -> Path:
    return Path(os.environ.get("LPC_YOLO_CONFIG_DIR", Path.home() / ".config" / "lpc_yolo_tpu")) / "settings.yaml"


class SettingsManager(dict):
    """The persisted user settings (JAX `utils/infra.py:69-110`): datasets_dir, weights_dir, runs_dir and the
    feature toggles, read from and saved to `settings_file()` (the file is written when it is missing)."""

    def __init__(self, file: Optional[Union[str, Path]] = None):
        self.file = Path(file) if file is not None else settings_file()
        defaults = {
            "settings_version": "0.1.0",
            "datasets_dir": str(Path.cwd() / "datasets"),
            "weights_dir": str(Path.cwd() / "weights"),
            "runs_dir": str(Path.cwd() / "runs"),
            "sync": False,
            "tensorboard": True,
            "api_key": "",
        }
        super().__init__(defaults)
        try:
            if self.file.exists():
                stored = yaml.safe_load(self.file.read_text()) or {}
                self.update({k: v for k, v in stored.items() if k in defaults})
            else:
                self.save()
        except OSError:
            pass

    def save(self) -> None:
        try:
            self.file.parent.mkdir(parents=True, exist_ok=True)
            self.file.write_text(yaml.safe_dump(dict(self), sort_keys=False))
        except OSError:
            pass

    def update(self, *args, **kw):  # type: ignore[override]
        super().update(*args, **kw)
        self.save()

    def reset(self) -> None:
        self.file.unlink(missing_ok=True)
        self.__init__(self.file)


def runs_dir() -> Path:
    """The runs root: the settings file's `runs_dir`, else ./runs."""
    f = settings_file()
    try:
        stored = yaml.safe_load(f.read_text()) if f.exists() else None
    except (OSError, yaml.YAMLError):
        stored = None
    if isinstance(stored, dict) and stored.get("runs_dir"):
        return Path(stored["runs_dir"])
    return Path.cwd() / "runs"


def increment_path(path: Union[str, Path], exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... when it exists, unless exist_ok; a file keeps its
    extension, a directory gets the number appended."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{n}{suffix}"
            if not os.path.exists(p):
                return Path(p)
    return path


def get_save_dir(task: str = "detect", mode: str = "predict", project: Optional[Union[str, Path]] = None,
                 name: Optional[str] = None, exist_ok: bool = False) -> Path:
    """{project or <runs_dir>/<task>}/{name or mode}, incremented unless exist_ok."""
    root = Path(project) if project else runs_dir() / task
    return increment_path(root / (name or mode), exist_ok=exist_ok)
