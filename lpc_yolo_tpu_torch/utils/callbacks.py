"""The lifecycle callback bus and its observability sinks (counterpart of `lpc_yolo_tpu/utils/callbacks.py`).

`EVENTS` is the reference's list of 25 lifecycle events (callbacks/base.py:145-175);
`CallbackRegistry` adds handlers per event and runs them with the emitting
component. `add_integration_callbacks` attaches the same sinks as the JAX
package, writing the same files: the MLflow file-store layout (`mlruns/`),
DVCLive's `dvclive/metrics.json` and `plots/metrics/*.tsv`, and `events.jsonl`,
none of which needs a package; TensorBoard when `torch.utils.tensorboard`
imports and wandb when its SDK imports. The port's trainer fires the JAX
trainer's five events (`engine/trainer.py`).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List

# The reference's event list (callbacks/base.py:145-175).
EVENTS = [
    # trainer
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_params_update",
    "teardown",
    # validator
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    # predictor
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_postprocess_end",
    "on_predict_batch_end",
    "on_predict_end",
    # exporter
    "on_export_start",
    "on_export_end",
]


def get_default_callbacks() -> Dict[str, List[Callable]]:
    return defaultdict(list, {e: [] for e in EVENTS})


class CallbackRegistry:
    """Event bus: add handlers per event, run them with the emitting component."""

    def __init__(self):
        self.callbacks = get_default_callbacks()

    def add(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown callback event '{event}'; valid: {EVENTS}")
        self.callbacks[event].append(fn)

    def run(self, event: str, *args: Any, **kw: Any) -> None:
        for fn in self.callbacks.get(event, []):
            fn(*args, **kw)

    def add_integration_callbacks(self, save_dir=None) -> List[str]:
        """Attach observability sinks (reference add_integration_callbacks).

        Dependency-free sinks always attach: the MLflow FILE-STORE layout
        (readable by `mlflow ui` without the mlflow package — mirrors
        callbacks/mlflow.py's file:// tracking-URI mode), the DVCLive
        metrics.json + plots/metrics/*.tsv layout (callbacks/dvc.py), and a
        JSONL event log. TensorBoard attaches when torch's SummaryWriter
        imports; wandb attaches with a real init/log/finish wiring when its
        SDK is installed. comet, clearml and neptune have no sink, as in the
        JAX package. Returns the names of the attached sinks.
        """
        attached = []
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401

            self._attach_tensorboard(save_dir)
            attached.append("tensorboard")
        except (ImportError, AttributeError):
            pass
        self._attach_mlflow_filestore(save_dir)
        attached.append("mlflow-filestore")
        self._attach_dvclive(save_dir)
        attached.append("dvclive")
        self._attach_jsonl(save_dir)
        attached.append("jsonl")
        try:
            import wandb  # noqa: F401

            self._attach_wandb(save_dir)
            attached.append("wandb")
        except ImportError:
            pass
        return attached

    def _attach_mlflow_filestore(self, save_dir):
        """Write the MLflow file-store layout directly (no mlflow dependency).

        Layout (mlflow.store.tracking.file_store): mlruns/<exp>/meta.yaml,
        mlruns/<exp>/<run_id>/meta.yaml, .../metrics/<key> lines of
        "<ts_ms> <value> <step>", .../params/<key>. `mlflow ui` pointed at
        the save_dir reads these runs natively.
        """
        import time
        import uuid
        from pathlib import Path

        state = {}

        def _init(trainer):
            root = Path(getattr(trainer, "save_dir", None) or save_dir or ".") / "mlruns"
            exp = root / "0"
            (exp).mkdir(parents=True, exist_ok=True)
            if not (exp / "meta.yaml").exists():
                (exp / "meta.yaml").write_text(
                    "artifact_location: {}\nexperiment_id: '0'\nlifecycle_stage: active\nname: Default\n".format(exp.as_posix())
                )
            run_id = uuid.uuid4().hex
            run = exp / run_id
            (run / "metrics").mkdir(parents=True, exist_ok=True)
            (run / "params").mkdir(parents=True, exist_ok=True)
            (run / "tags").mkdir(parents=True, exist_ok=True)
            start = int(time.time() * 1000)
            (run / "meta.yaml").write_text(
                "artifact_uri: {}/artifacts\nexperiment_id: '0'\nlifecycle_stage: active\n"
                "run_id: {}\nrun_uuid: {}\nrun_name: train\nstatus: 1\nstart_time: {}\n".format(
                    run.as_posix(), run_id, run_id, start
                )
            )
            (run / "tags" / "mlflow.runName").write_text("train")
            for k, v in (getattr(trainer, "args", None) or {}).items() if isinstance(getattr(trainer, "args", None), dict) else []:
                try:
                    (run / "params" / str(k)).write_text(str(v))
                except OSError:
                    pass
            state["run"] = run

        def on_fit_epoch_end(trainer):
            if "run" not in state:
                _init(trainer)
            run = state["run"]
            epoch = getattr(trainer, "epoch", 0)
            ts = int(time.time() * 1000)
            for k, v in getattr(trainer, "last_metrics", {}).items():
                try:
                    val = float(v)
                except (TypeError, ValueError):
                    continue
                key = k.replace("/", "_").replace("(", "").replace(")", "")
                with open(run / "metrics" / key, "a") as f:
                    f.write(f"{ts} {val} {epoch}\n")

        def on_train_end(trainer):
            run = state.get("run")
            if run is not None:
                import time as _t

                meta = (run / "meta.yaml").read_text().replace("status: 1", "status: 3")
                (run / "meta.yaml").write_text(meta + f"end_time: {int(_t.time() * 1000)}\n")

        self.add("on_pretrain_routine_end", _init)
        self.add("on_fit_epoch_end", on_fit_epoch_end)
        self.add("on_train_end", on_train_end)

    def _attach_dvclive(self, save_dir):
        """DVCLive on-disk layout (callbacks/dvc.py without the dvclive dep):
        <save_dir>/dvclive/metrics.json (latest values) and
        plots/metrics/<key>.tsv (step\\tvalue history)."""
        import json
        from pathlib import Path

        def on_fit_epoch_end(trainer):
            root = Path(getattr(trainer, "save_dir", None) or save_dir or ".") / "dvclive"
            plots = root / "plots" / "metrics"
            plots.mkdir(parents=True, exist_ok=True)
            epoch = getattr(trainer, "epoch", 0)
            latest = {}
            if (root / "metrics.json").exists():
                try:
                    latest = json.loads((root / "metrics.json").read_text())
                except json.JSONDecodeError:
                    latest = {}
            for k, v in getattr(trainer, "last_metrics", {}).items():
                try:
                    val = float(v)
                except (TypeError, ValueError):
                    continue
                key = k.replace("/", "_")
                latest[key] = val
                tsv = plots / f"{key}.tsv"
                if not tsv.exists():
                    tsv.write_text(f"step\t{key}\n")
                with open(tsv, "a") as f:
                    f.write(f"{epoch}\t{val}\n")
            latest["step"] = epoch
            (root / "metrics.json").write_text(json.dumps(latest, indent=2))

        self.add("on_fit_epoch_end", on_fit_epoch_end)

    def _attach_jsonl(self, save_dir):
        """Append one JSON object per epoch to events.jsonl (generic sink)."""
        import json
        import time
        from pathlib import Path

        def on_fit_epoch_end(trainer):
            root = Path(getattr(trainer, "save_dir", None) or save_dir or ".")
            root.mkdir(parents=True, exist_ok=True)
            rec = {"event": "fit_epoch_end", "epoch": getattr(trainer, "epoch", 0), "time": time.time()}
            for k, v in getattr(trainer, "last_metrics", {}).items():
                try:
                    rec[k] = float(v)
                except (TypeError, ValueError):
                    pass
            with open(root / "events.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")

        self.add("on_fit_epoch_end", on_fit_epoch_end)

    def _attach_wandb(self, save_dir):
        """Real wandb wiring (only reached when the SDK imports)."""
        import wandb

        state = {}

        def on_pretrain_routine_end(trainer):
            if wandb.run is None:
                args = getattr(trainer, "args", None)
                state["run"] = wandb.init(
                    project="lpc-yolo-tpu", config=args if isinstance(args, dict) else None
                )

        def on_fit_epoch_end(trainer):
            if wandb.run is not None:
                metrics = {
                    k: float(v)
                    for k, v in getattr(trainer, "last_metrics", {}).items()
                    if isinstance(v, (int, float))
                }
                wandb.log(metrics, step=getattr(trainer, "epoch", 0))

        def on_train_end(trainer):
            if wandb.run is not None:
                wandb.finish()

        self.add("on_pretrain_routine_end", on_pretrain_routine_end)
        self.add("on_fit_epoch_end", on_fit_epoch_end)
        self.add("on_train_end", on_train_end)

    def _attach_tensorboard(self, save_dir):
        from torch.utils.tensorboard import SummaryWriter

        # lazy: SummaryWriter creates its events file at construction, which
        # would litter runs/ for Trainers that never train (autobatch probes,
        # facade construction)
        state = {}

        def writer():
            if "w" not in state:
                state["w"] = SummaryWriter(log_dir=str(save_dir) if save_dir else None)
            return state["w"]

        def on_fit_epoch_end(trainer):
            epoch = getattr(trainer, "epoch", 0)
            for k, v in getattr(trainer, "last_metrics", {}).items():
                try:
                    writer().add_scalar(k, float(v), epoch)
                except (TypeError, ValueError):
                    pass

        def on_train_end(trainer):
            if "w" in state:
                state["w"].flush()
                state["w"].close()

        self.add("on_fit_epoch_end", on_fit_epoch_end)
        self.add("on_train_end", on_train_end)
