"""The trainer: epochs of training steps from a dataset or from host batches.

Counterpart of `lpc_yolo_tpu/engine/trainer.py::Trainer.train` (:174-418).
From a dataset (`data=`): `check_det_dataset` and the class-count check
(:186-189), the train split through `TrainTransforms` and the infinite,
shuffled, seeded loader (:207-227), `steps_per_epoch = len(loader)`, warmup
and total steps, the "auto" optimizer rule (:232-247), `close_mosaic`
(:305-306), the time each epoch waits on the loader (`input_wait_frac`,
:313-317, :384; here the loader plans and the trainer renders, so the render
is outside this wait and has its own share, `render_frac`) and a validation on the EMA weights with the live BatchNorm
statistics after every epoch, at `batch=min(batch, 8)` (:268-270, :349-353).
`train()` returns the last validation's results dict, as the JAX trainer does.
A Segment model trains through `SegTrainTransforms` (:215-216): its
batches carry each instance's mask, rasterized in the loader's threads, and
its results.csv the `train/seg` column and the validator's `(M)` keys. A
Pose model trains through `PoseTrainTransforms` (:217-219) with the data
YAML's `kpt_shape` (COCO's (17, 3) when it gives none) and `flip_idx`: its
batches carry the keypoints, its results.csv the `train/pose` and
`train/kobj` columns and the validator's `(P)` keys. An OBB model trains on
the set's rotated boxes (`YOLODataset(obb=True)`) through
`OBBTrainTransforms` (:220-222: letterbox and HSV, no mosaic): its batches
carry `rboxes`, its results.csv the `train/box`, `train/cls` and
`train/dfl` columns. An RT-DETR model trains through the detect
`TrainTransforms` (:223-224) with the DETR loss (`losses/detr.py`): its
results.csv has the `train/cls`, `train/l1` and `train/giou` columns, and its
denoising draws are keyed by the step's count, so a resumed run draws what
an uninterrupted one would. A YOLO-World model trains as a Detect model does
(the JAX trainer routes it so, :191-203), its class logits from the text
table of the dataset's names in index order: the facade's `set_classes`
takes them before the first step, so the per-epoch validation and a
`predict` after training read the same table. (The JAX train step passes no
text, so its World graph learns from zero text: ROADMAP Queue 3.) From host
batches it trains on the facade's table as it stands.

The loader's threads read the frames and make each sample's plan (its
random draws, geometry and labels). The trainer renders each batch on the
device (`data/augment.py::render`: mosaic tiles, mixup, the affine warp, HSV
and flips) and ships the rendered uint8 batch width-packed x8, (B, H, W/8,
24), a free view that the step unpacks through the repack kernel. Nothing is
rendered, resized or trained on the CPU when the device is the card.

From host batches (`batches=`): the same step loop over an iterable of
loader-format batches: `img` uint8 BGR (B, H, W, 3), `cls` (B, M) int32,
`bboxes` (B, M, 4) xyxy pixels, `mask` (B, M) bool (a segment model's also
`masks` (B, M, H/4, W/4) uint8, a pose model's `keypoints` (B, M, K, ndim)
f32 pixels, an OBB model's `rboxes` (B, M, 5) f32 pixels); the trainer packs `img`
x8 on the host when W % 8 == 0. Returns the last epoch's mean loss items.

After the last step the facade holds the EMA parameters with the live
BatchNorm statistics (:412-418). `history` holds one entry per step (loss,
items, lr, skipped, seconds, input_wait_s, render_s), `epoch_history` one row
per epoch (mean loss items, lr, seconds, input_wait_frac, render_frac and the
validation's results). `render_s` is the host's time in the render call: its
tables, the pinned copy of the source frames and the launches; the device
work it enqueues runs on behind the host, before the step's.

The rest of the epoch loop (:252-411), with the JAX package's files:
`save_dir` (or `{project or <runs_dir>/<task>}/{name or "train"}`,
incremented unless `exist_ok`) gets `weights/last.ckpt` every epoch while
`save` and at the final epoch, `weights/best.ckpt` when the validation's
fitness is at least the best so far, `weights/epoch{N}.ckpt` every
`save_period` epochs, and `results.csv`, one row per epoch in the JAX
columns with `render_frac` last. A `.ckpt` holds the whole state in the JAX
`TrainState`'s tree with meta {"epoch", "fitness"} (`utils/checkpoint.py`,
`utils/flax_bridge.py::train_state_dict`), so either package resumes the
other's run; one device-to-host copy of the state serves every file of an
epoch. `EarlyStopping(patience)` ends the run after `patience` epochs
without a better fitness.

`resume=True` loads `last.ckpt` (of `save_dir`, or of the newest run of
`name` that has one) and runs the epochs after it. Where the JAX trainer
would make a resumed run differ from one that was never stopped, the port
does not: the loader restarts at the resumed epoch (its shuffle and draws
are those of that epoch, not of epoch 0), mosaic is closed when the run
resumes past the close epoch, the best fitness and EarlyStopping's count
come back from `best.ckpt`'s meta, and a stop (SIGTERM or SIGINT, caught on
the main thread only: the step in flight finishes, then the run ends) writes
no mid-epoch state, so `last.ckpt` stays the end of the last whole epoch and
a resume runs the stopped epoch again from its start.

`batch=-1` picks the batch first (JAX :144-172, :203-210,
`utils/autobatch.py`): the largest power of two up to 128 whose training
step fits 60% of the card's memory. Each candidate runs one real step (SGD,
as the JAX probe compiles it) on zero inputs of the real shapes and the
task's targets, on a copy of the model under a forked generator state, so
the parameters, BN statistics, EMA and every seeded generator stay as they
were and `train(batch=-1)` is the run of `train(batch=<the chosen batch>)`;
`autobatch_probes` keeps each probe's (batch, peak bytes, limit bytes).

`cache_augmented` (False, True or a capacity; JAX :289-299) serves the
steps from an `AugmentedCache` window of the loader's host batches (plans,
sources and labels), refreshed by a background thread and refilled at the
close_mosaic boundary; each served batch is rendered on the device as a
fresh one is. The window's capacity is the given one, or for True
min(steps per epoch, 16); `aug_cache` keeps it after the run
(`echo_factor()`).

Callbacks (`utils/callbacks.py`): the facade's (`YOLO.add_callback`) first,
then the JAX package's sinks under `save_dir` (MLflow file store, DVCLive,
events.jsonl; TensorBoard and wandb when they import). The trainer fires
`on_train_start`, `on_train_epoch_start`, `on_model_save`, `on_fit_epoch_end`
(with `last_metrics`, the epoch's results.csv row) and `on_train_end` where
the JAX trainer fires them (:272, :304, :371, :398, :411).
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import signal
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..data import (DataLoader, OBBTrainTransforms, PoseTrainTransforms, SegTrainTransforms, TrainTransforms,
                    YOLODataset, check_det_dataset, render)
from ..utils import msgpack, resolve_device
from ..utils.callbacks import CallbackRegistry
from ..utils.checkpoint import load_checkpoint, read_meta, write_checkpoint
from ..utils.flax_bridge import train_state_dict, train_state_from_dict
from ..utils.infra import get_save_dir
from .train_step import OptConfig, TrainState, init_train_state, make_train_step

# the loss items' names by task (JAX `engine/trainer.py:33-40`): results.csv's train/ columns
LOSS_NAMES = {"v10": ("box_om", "cls_om", "dfl_om", "box_oo", "cls_oo", "dfl_oo"), "v8": ("box", "cls", "dfl"),
              "segment": ("box", "seg", "cls", "dfl"), "pose": ("box", "pose", "kobj", "cls", "dfl"),
              "obb": ("box", "cls", "dfl"), "rtdetr": ("cls", "l1", "giou"), "world": ("box", "cls", "dfl")}


def pack_img(img):
    """(B, H, W, 3) -> the width-packed x8 feed (B, H, W/8, 24) when it applies (same bytes)."""
    if img.ndim == 4 and img.shape[2] % 8 == 0 and img.shape[-1] == 3:
        b, h, w, c = img.shape
        return img.reshape(b, h, w // 8, 8 * c)
    return img


class EarlyStopping:
    """Stop when the fitness has not improved for `patience` epochs (JAX `engine/trainer.py:43-55`)."""

    def __init__(self, patience: int = 50):
        self.patience = patience or float("inf")
        self.best_fitness = 0.0
        self.best_epoch = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def host_state(state: TrainState) -> TrainState:
    """The state with every tensor on the host, through one device-to-host copy of all of them."""
    trees = {f: getattr(state, f) for f in ("params", "batch_stats", "momentum", "ema_params", "nu")}
    flat = [t.detach() for tree in trees.values() for t in tree.values()]
    if flat[0].device.type == "cpu":
        return state
    host = torch.cat([t.float().reshape(-1) for t in flat]).cpu()
    pieces = iter(torch.split(host, [t.numel() for t in flat]))
    return dataclasses.replace(state, **{f: {k: next(pieces).view(t.shape) for k, t in tree.items()}
                                         for f, tree in trees.items()})


def ema_model(model: torch.nn.Module, state: TrainState) -> torch.nn.Module:
    """A copy of `model` in eval mode with the EMA parameters and the live BatchNorm statistics."""
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.grad = None
    with torch.no_grad():
        ema.load_state_dict(state.ema_params, strict=False)
    return ema.eval()


def hand_back(yolo, model: torch.nn.Module, state: TrainState) -> None:
    """Load the EMA parameters with `model`'s live BatchNorm statistics into the facade's model (JAX
    `engine/trainer.py:412-418`)."""
    with torch.no_grad():
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        sd.update(state.ema_params)
        dev = next(yolo.model.parameters()).device
        yolo.model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)


def append_row(path: Path, row: Dict[str, Any]) -> None:
    """One row of results.csv, with the header when the file is new (JAX `engine/trainer.py:386-388`)."""
    write_header = not path.exists()
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if write_header:
            w.writeheader()
        w.writerow(row)


class Trainer:
    """`Trainer(yolo, data=<dataset yaml>, epochs=...).train()`, or `Trainer(yolo, batches, ...)`."""

    def __init__(self, yolo, batches: Optional[Iterable[Mapping[str, Any]]] = None, data=None, epochs: int = 100,
                 batch: int = 16, imgsz: int = 640, lr0: float = 0.01, lrf: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, warmup_epochs: float = 3.0, optimizer: str = "auto", workers: int = 8,
                 max_gt: int = 128, close_mosaic: int = 10, val: bool = True, save: bool = True,
                 save_period: int = -1, save_dir: Union[str, Path, None] = None, project: Union[str, Path, None] = None,
                 name: Optional[str] = None, exist_ok: bool = False, patience: int = 50, seed: int = 0,
                 resume: bool = False, hyp: Optional[Dict] = None, cache: Any = False, cache_augmented: Any = False,
                 device: Union[str, torch.device, None] = None):
        if (batches is None) == (data is None):
            raise ValueError("pass either data=<dataset yaml> or batches=<iterable of host batches>")
        self.yolo, self.data, self.epochs = yolo, data, epochs
        self.batches = None if batches is None else (batches if hasattr(batches, "__len__") else list(batches))
        self.batch, self.imgsz, self.workers, self.max_gt = batch, imgsz, workers, max_gt
        self.close_mosaic, self.do_val, self.seed, self.hyp, self.cache = close_mosaic, val, seed, hyp, cache
        self.cache_augmented = cache_augmented
        self.save, self.save_period, self.patience, self.resume = save, save_period, patience, resume
        self.save_dir = self._save_dir(save_dir, project, name, exist_ok)
        self.device = resolve_device(device or yolo.device)
        self._opt_kw = dict(lr0=lr0, lrf=lrf, momentum=momentum, weight_decay=weight_decay,
                            warmup_epochs=warmup_epochs, optimizer=optimizer)
        self.cfg: Optional[OptConfig] = None
        self.history: List[Dict[str, Any]] = []
        self.epoch_history: List[Dict[str, Any]] = []
        self.ckpt_seconds: List[Dict[str, float]] = []  # per save: the host copy + encode, and the writes
        self.state: TrainState = None
        self.start_epoch = 0
        self.preempted = False
        self.epoch = 0
        self.last_metrics: Dict[str, Any] = {}
        self.autobatch_probes: List[Tuple[int, int, int]] = []
        self.aug_cache = None
        self.callbacks = CallbackRegistry()
        for event, fns in getattr(yolo, "callbacks", {}).items():  # the facade's hooks first (JAX :130-138)
            for fn in fns:
                self.callbacks.add(event, fn)
        self.callbacks.add_integration_callbacks(save_dir=self.save_dir)

    def _save_dir(self, save_dir, project, name, exist_ok) -> Path:
        """An explicit save_dir as it is; else the JAX run directory, and on resume the newest run of
        `name` that has a last.ckpt (JAX `engine/trainer.py:105-122`)."""
        if save_dir is not None:
            return Path(save_dir)
        out = get_save_dir(getattr(self.yolo, "task", None) or "detect", "train", project, name, exist_ok)
        if self.resume:
            runs = sorted((p for p in out.parent.glob(f"{name or 'train'}*") if (p / "weights" / "last.ckpt").exists()),
                          key=lambda p: p.stat().st_mtime)
            if runs:
                out = runs[-1]
        return out

    def opt_config(self, steps_per_epoch: int, nc: int) -> OptConfig:
        """The optimizer config, with the reference's "auto" rule: AdamW (lr0 0.002) for runs of
        at most 10000 steps on at most 20 classes, else SGD; AdamW's b1 is 0.9."""
        kw = self._opt_kw
        total_steps = steps_per_epoch * self.epochs
        name, lr0 = kw["optimizer"], kw["lr0"]
        if name == "auto":
            name = "adamw" if total_steps <= 10000 and nc <= 20 else "sgd"
            lr0 = 0.002 if name == "adamw" else lr0
        if name not in ("sgd", "adamw"):
            raise NotImplementedError(f"optimizer {name!r} is not ported; use 'sgd', 'adamw' or 'auto'")
        return OptConfig(lr0=lr0, lrf=kw["lrf"], momentum=kw["momentum"] if name == "sgd" else 0.9,
                         weight_decay=kw["weight_decay"],
                         warmup_steps=max(int(kw["warmup_epochs"] * steps_per_epoch), 100),
                         total_steps=total_steps, optimizer=name)

    def _autobatch(self, model: torch.nn.Module, task: str, kpt_shape=None, max_batch: int = 128) -> int:
        """Resolve batch=-1: the largest power-of-two batch whose train step fits 60% of the card's memory
        (`utils/autobatch.py`). Each probe trains a copy of `model` one SGD step on zero inputs of the real
        shapes (the packed uint8 frames, `max_gt` label rows and the task's targets, JAX :157-170), under a
        forked generator state; the probes' (batch, peak, limit) go to `autobatch_probes`."""
        from ..utils import autobatch as ab

        probe_cfg = OptConfig(total_steps=1000, warmup_steps=100)
        M, sz = self.max_gt, self.imgsz

        def zeros(b: int) -> Dict[str, np.ndarray]:
            batch = {"img": pack_img(np.zeros((b, sz, sz, 3), np.uint8)), "cls": np.zeros((b, M), np.int32),
                     "bboxes": np.zeros((b, M, 4), np.float32), "mask": np.zeros((b, M), bool)}
            if task == "segment":
                batch["masks"] = np.zeros((b, M, sz // 4, sz // 4), np.uint8)
            elif task == "pose":
                batch["keypoints"] = np.zeros((b, M) + tuple(kpt_shape or (17, 3)), np.float32)
            elif task == "obb":
                batch["rboxes"] = np.zeros((b, M, 5), np.float32)
            return batch

        def make_fn(b: int):
            def probe():
                devices = [self.device] if self.device.type == "cuda" else []
                with torch.random.fork_rng(devices=devices):
                    copy_ = copy.deepcopy(model)
                    state = init_train_state(copy_, probe_cfg, self.device)
                    make_train_step(copy_, probe_cfg, loss_kind=task, text=self.yolo.txt_feats)(state, zeros(b))

            return probe, ()

        self.autobatch_probes = []
        return ab.autobatch(make_fn, max_batch=max_batch, device=self.device, probes=self.autobatch_probes)

    def _request_stop(self, signum, frame) -> None:
        self.preempted = True

    def _start(self, model: torch.nn.Module, last: Path, best: Path, stopper: EarlyStopping) -> Tuple[TrainState, float]:
        """A fresh state, or on resume the state of last.ckpt (setting `start_epoch`), and the best
        fitness so far (best.ckpt's meta, which also restores EarlyStopping's count)."""
        if not (self.resume and last.exists()):
            return init_train_state(model, self.cfg, self.device), 0.0
        tree, meta = load_checkpoint(last)
        state = train_state_from_dict(model, self.cfg, tree, self.device)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        best_meta = read_meta(best) if best.exists() else {}
        stopper.best_fitness = float(best_meta.get("fitness", 0.0))
        stopper.best_epoch = int(best_meta.get("epoch", self.start_epoch - 1))
        print(f"resuming {last} at epoch {self.start_epoch + 1}/{self.epochs} (step {state.step})")
        return state, stopper.best_fitness

    def _save(self, state: TrainState, epoch: int, fitness: float, is_best: bool, last: Path, best: Path) -> None:
        """last.ckpt, best.ckpt when is_best, epoch{N}.ckpt every save_period epochs: one host copy and
        one encoding of the state serve all of them."""
        t0 = time.perf_counter()
        blob = msgpack.to_bytes(train_state_dict(host_state(state), self.cfg))
        t1 = time.perf_counter()
        meta = {"epoch": epoch, "fitness": fitness}
        if is_best:
            write_checkpoint(best, blob, meta)
        write_checkpoint(last, blob, meta)
        if self.save_period > 0 and epoch > 0 and epoch % self.save_period == 0:
            write_checkpoint(last.with_name(f"epoch{epoch}.ckpt"), blob, meta)
        self.ckpt_seconds.append({"encode_s": t1 - t0, "write_s": time.perf_counter() - t1, "bytes": len(blob)})

    def train(self) -> Dict[str, float]:
        # train a copy: the facade's model stays as it is until the hand-back
        model = copy.deepcopy(self.yolo.model)
        transforms = info = None
        kpt_shape = None
        if self.data is not None:
            info = check_det_dataset(self.data)
            if model.nc != info["nc"]:
                raise ValueError(f"model nc={model.nc} != dataset nc={info['nc']}; "
                                 f"build the model with YOLO(cfg, nc={info['nc']})")
            if self.yolo.task == "world":
                self.yolo.set_classes([info["names"][i] for i in sorted(info["names"])])
            kpt_shape = info.get("kpt_shape")
        if self.batch == -1:
            self.batch = self._autobatch(model, self.yolo.task, kpt_shape)
            print(f"autobatch: using batch={self.batch}")
        if self.data is not None:
            dataset = YOLODataset(info["train"], cache_images=self.cache, kpt_shape=kpt_shape,
                                  obb=self.yolo.task == "obb")
            if self.yolo.task == "obb":
                transforms = OBBTrainTransforms(self.imgsz, self.hyp, self.max_gt)
            elif self.yolo.task == "pose":
                transforms = PoseTrainTransforms(self.imgsz, self.hyp, self.max_gt, kpt_shape or (17, 3),
                                                 flip_idx=info.get("flip_idx"))
            else:
                kind = SegTrainTransforms if self.yolo.task == "segment" else TrainTransforms
                transforms = kind(self.imgsz, self.hyp, self.max_gt)
            loader = DataLoader(dataset, transforms.plan, batch_size=self.batch, workers=self.workers,
                                shuffle=True, seed=self.seed, infinite=True)
            steps_per_epoch = len(loader)
        else:
            steps_per_epoch = len(self.batches)
        self.cfg = self.opt_config(max(steps_per_epoch, 1), model.nc)
        last, best = self.save_dir / "weights" / "last.ckpt", self.save_dir / "weights" / "best.ckpt"
        stopper = self.stopper = EarlyStopping(self.patience)
        state, best_fitness = self._start(model, last, best, stopper)
        train_step = make_train_step(model, self.cfg, loss_kind=self.yolo.task, text=self.yolo.txt_feats)
        names = LOSS_NAMES[self.yolo.task]
        if transforms is not None:
            loader.epoch = self.start_epoch  # the resumed epoch's shuffle and draws
            if self.cache_augmented:
                from ..data.shard_cache import AugmentedCache

                capacity = (int(self.cache_augmented) if not isinstance(self.cache_augmented, bool)
                            else min(steps_per_epoch, 16))
                self.aug_cache = AugmentedCache(loader, capacity=capacity, seed=self.seed)
                data_iter = iter(self.aug_cache)
            else:
                data_iter = iter(loader)
        close_at = self.epochs - self.close_mosaic  # mosaic off from this epoch, also when resuming past it
        csv_path = self.save_dir / "results.csv"
        self.preempted = False
        handlers = {}
        if threading.current_thread() is threading.main_thread():
            handlers = {sig: signal.signal(sig, self._request_stop) for sig in (signal.SIGTERM, signal.SIGINT)}
        mean_items, results = np.zeros(len(names)), {}
        self.callbacks.run("on_train_start", self)
        try:
            for epoch in range(self.start_epoch, self.epochs):
                self.epoch = epoch
                self.callbacks.run("on_train_epoch_start", self)
                if transforms is not None and close_at >= 0 and epoch == max(close_at, self.start_epoch):
                    transforms.close_mosaic()
                    if self.aug_cache is not None:
                        self.aug_cache.invalidate()  # stale mosaic batches must not reach the last epochs
                t_epoch, wait_s, render_s, n_skipped, lr = time.perf_counter(), 0.0, 0.0, 0, 0.0
                mean_items[:] = 0
                source = data_iter if transforms is not None else iter(self.batches)
                for _ in range(steps_per_epoch):
                    t0 = time.perf_counter()
                    batch = next(source)
                    wait = time.perf_counter() - t0
                    wait_s += wait
                    host_batch = {k: batch[k] for k in ("cls", "bboxes", "mask", "masks", "keypoints", "rboxes")
                                  if k in batch}
                    t1 = time.perf_counter()
                    img = batch["img"] if transforms is None else render(batch["plan"], batch["sources"], self.device)
                    rendering = time.perf_counter() - t1
                    render_s += rendering
                    host_batch["img"] = pack_img(img)
                    state, metrics = train_step(state, host_batch)
                    items = metrics["items"].cpu().numpy()
                    mean_items += items / steps_per_epoch
                    n_skipped += int(metrics["skipped"])
                    lr = metrics["lr"]
                    self.history.append({"epoch": epoch, "loss": float(metrics["loss"]), "items": items.tolist(),
                                         "lr": lr, "skipped": metrics["skipped"],
                                         "seconds": time.perf_counter() - t0, "input_wait_s": wait,
                                         "render_s": rendering})
                    if self.preempted:
                        break
                if self.preempted:
                    print(f"stopped in epoch {epoch + 1}/{self.epochs}: {last} holds the end of epoch {epoch}; "
                          f"resume=True runs epoch {epoch + 1} again from its start")
                    break
                if n_skipped:
                    print(f"WARNING: {n_skipped}/{steps_per_epoch} steps skipped (non-finite loss/grads)")
                results = {}
                if transforms is not None and self.do_val and info.get("val"):
                    results = self.validate(model, state)
                fitness = results.get("fitness", 0.0)
                is_best = bool(results) and fitness >= best_fitness
                best_fitness = max(best_fitness, fitness)
                if self.save or epoch == self.epochs - 1:
                    self._save(state, epoch, fitness, is_best, last, best)
                    self.callbacks.run("on_model_save", self)
                seconds = time.perf_counter() - t_epoch
                # the JAX row, its lr the f32 that the JAX step returns
                csv_row = {"epoch": epoch, **{f"train/{n}": round(float(v), 5) for n, v in zip(names, mean_items)},
                           **{k: round(float(v), 5) for k, v in results.items()}, "lr": float(np.float32(lr)),
                           "time_s": round(seconds, 1), "input_wait_frac": round(wait_s / max(seconds, 1e-9), 4),
                           "render_frac": round(render_s / max(seconds, 1e-9), 4)}
                self.save_dir.mkdir(parents=True, exist_ok=True)
                append_row(csv_path, csv_row)
                self.epoch_history.append({"epoch": epoch, **dict(zip(names, mean_items.tolist())), "lr": lr,
                                           "seconds": seconds, "input_wait_frac": wait_s / max(seconds, 1e-9),
                                           "render_frac": render_s / max(seconds, 1e-9), **results})
                print(f"epoch {epoch + 1}/{self.epochs} "
                      + " ".join(f"{n}={v:.3f}" for n, v in zip(names, mean_items))
                      + (f" mAP50-95={results.get('metrics/mAP50-95(B)', 0):.4f}" if results else ""))
                self.last_metrics = csv_row
                self.callbacks.run("on_fit_epoch_end", self)
                if stopper(epoch, fitness):
                    print(f"early stop at epoch {epoch + 1} (best epoch {stopper.best_epoch + 1})")
                    break
        finally:
            for sig, h in handlers.items():
                signal.signal(sig, h)
            if self.aug_cache is not None:
                self.aug_cache.stop()  # ends its refresh thread and the loader's threads
            elif transforms is not None:
                data_iter.close()  # stops the loader's threads
        if self.aug_cache is not None:
            print(f"aug cache: echo factor {self.aug_cache.echo_factor():.2f} "
                  f"({self.aug_cache.refreshed} refreshed / {self.aug_cache.served} served)")
        self.callbacks.run("on_train_end", self)
        hand_back(self.yolo, model, state)
        self.state = state
        return results if transforms is not None else dict(zip(names, mean_items.tolist()))

    def validate(self, model: torch.nn.Module, state: TrainState) -> Dict[str, float]:
        """The validator on the EMA parameters with the live BN statistics, at batch min(batch, 8);
        the dataset's images read as in training (`cache`)."""
        from .validator import Validator

        validator = Validator(self.yolo, imgsz=self.imgsz, batch=min(self.batch, 8), max_gt=self.max_gt,
                              workers=self.workers, cache_images=self.cache, device=self.device)
        self.validator = validator
        return validator(self.data, model=ema_model(model, state))
