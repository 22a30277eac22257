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

The loader's threads read the frames and make each sample's plan (its
random draws, geometry and labels). The trainer renders each batch on the
device (`data/augment.py::render`: mosaic tiles, mixup, the affine warp, HSV
and flips) and ships the rendered uint8 batch width-packed x8, (B, H, W/8,
24), a free view that the step unpacks through the repack kernel. Nothing is
rendered, resized or trained on the CPU when the device is the card.

From host batches (`batches=`): the same step loop over an iterable of
loader-format batches: `img` uint8 BGR (B, H, W, 3), `cls` (B, M) int32,
`bboxes` (B, M, 4) xyxy pixels, `mask` (B, M) bool; the trainer packs `img`
x8 on the host when W % 8 == 0. Returns the last epoch's mean loss items.

After the last step the facade holds the EMA parameters with the live
BatchNorm statistics (:412-418). `history` holds one entry per step (loss,
items, lr, skipped, seconds, input_wait_s, render_s), `epoch_history` one row
per epoch (mean loss items, lr, seconds, input_wait_frac, render_frac and the
validation's results). `render_s` is the host's time in the render call: its
tables, the pinned copy of the source frames and the launches; the device
work it enqueues runs on behind the host, before the step's.

Not ported yet, and refused when asked for: checkpoints (`save=True`, the
port's default is save=False until the checkpoint slice, and `save_period`),
`resume`, `cache_augmented`, autobatch (`batch=-1`); callbacks, the results
CSV and early stopping are not run.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from ..data import DataLoader, TrainTransforms, YOLODataset, check_det_dataset, render
from ..utils import resolve_device
from .train_step import OptConfig, TrainState, init_train_state, make_train_step

LOSS_NAMES = ("box_om", "cls_om", "dfl_om", "box_oo", "cls_oo", "dfl_oo")


def pack_img(img):
    """(B, H, W, 3) -> the width-packed x8 feed (B, H, W/8, 24) when it applies (same bytes)."""
    if img.ndim == 4 and img.shape[2] % 8 == 0 and img.shape[-1] == 3:
        b, h, w, c = img.shape
        return img.reshape(b, h, w // 8, 8 * c)
    return img


class Trainer:
    """`Trainer(yolo, data=<dataset yaml>, epochs=...).train()`, or `Trainer(yolo, batches, ...)`."""

    def __init__(self, yolo, batches: Optional[Iterable[Mapping[str, Any]]] = None, data=None, epochs: int = 100,
                 batch: int = 16, imgsz: int = 640, lr0: float = 0.01, lrf: float = 0.01, momentum: float = 0.937,
                 weight_decay: float = 5e-4, warmup_epochs: float = 3.0, optimizer: str = "auto", workers: int = 8,
                 max_gt: int = 128, close_mosaic: int = 10, val: bool = True, save: bool = False,
                 save_period: int = -1, seed: int = 0, resume: bool = False, hyp: Optional[Dict] = None,
                 cache: Any = False, cache_augmented: Any = False, device: Union[str, torch.device, None] = None):
        refused = {"save=True": save, "save_period": save_period != -1, "resume": resume,
                   "cache_augmented": cache_augmented, "batch=-1 (autobatch)": batch == -1}
        for what, asked in refused.items():
            if asked:
                raise NotImplementedError(f"{what} is not ported yet (checkpoints, resume and autobatch come later)")
        if (batches is None) == (data is None):
            raise ValueError("pass either data=<dataset yaml> or batches=<iterable of host batches>")
        self.yolo, self.data, self.epochs = yolo, data, epochs
        self.batches = None if batches is None else (batches if hasattr(batches, "__len__") else list(batches))
        self.batch, self.imgsz, self.workers, self.max_gt = batch, imgsz, workers, max_gt
        self.close_mosaic, self.do_val, self.seed, self.hyp, self.cache = close_mosaic, val, seed, hyp, cache
        self.device = resolve_device(device or yolo.device)
        self._opt_kw = dict(lr0=lr0, lrf=lrf, momentum=momentum, weight_decay=weight_decay,
                            warmup_epochs=warmup_epochs, optimizer=optimizer)
        self.cfg: Optional[OptConfig] = None
        self.history: List[Dict[str, Any]] = []
        self.epoch_history: List[Dict[str, Any]] = []
        self.state: TrainState = None

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

    def train(self) -> Dict[str, float]:
        # train a copy: the facade's model stays as it is until the hand-back
        model = copy.deepcopy(self.yolo.model)
        transforms = info = None
        if self.data is not None:
            info = check_det_dataset(self.data)
            if model.nc != info["nc"]:
                raise ValueError(f"model nc={model.nc} != dataset nc={info['nc']}; "
                                 f"build the model with YOLO(cfg, nc={info['nc']})")
            dataset = YOLODataset(info["train"], cache_images=self.cache)
            transforms = TrainTransforms(self.imgsz, self.hyp, self.max_gt)
            loader = DataLoader(dataset, transforms.plan, batch_size=self.batch, workers=self.workers,
                                shuffle=True, seed=self.seed, infinite=True)
            steps_per_epoch, data_iter = len(loader), iter(loader)
        else:
            steps_per_epoch = len(self.batches)
        self.cfg = self.opt_config(max(steps_per_epoch, 1), model.nc)
        state = init_train_state(model, self.cfg, self.device)
        train_step = make_train_step(model, self.cfg, loss_kind=self.yolo.task)
        mean_items, results = np.zeros(6), {}
        try:
            for epoch in range(self.epochs):
                if transforms is not None and epoch == self.epochs - self.close_mosaic:
                    transforms.close_mosaic()
                t_epoch, wait_s, render_s, n_skipped, lr = time.perf_counter(), 0.0, 0.0, 0, 0.0
                mean_items[:] = 0
                source = data_iter if transforms is not None else iter(self.batches)
                for _ in range(steps_per_epoch):
                    t0 = time.perf_counter()
                    batch = next(source)
                    wait = time.perf_counter() - t0
                    wait_s += wait
                    host_batch = {k: batch[k] for k in ("cls", "bboxes", "mask")}
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
                if n_skipped:
                    print(f"WARNING: {n_skipped}/{steps_per_epoch} steps skipped (non-finite loss/grads)")
                if transforms is not None and self.do_val and info.get("val"):
                    results = self.validate(model, state)
                seconds = time.perf_counter() - t_epoch
                self.epoch_history.append({"epoch": epoch, **dict(zip(LOSS_NAMES, mean_items.tolist())), "lr": lr,
                                           "seconds": seconds, "input_wait_frac": wait_s / max(seconds, 1e-9),
                                           "render_frac": render_s / max(seconds, 1e-9), **results})
                print(f"epoch {epoch + 1}/{self.epochs} "
                      + " ".join(f"{n}={v:.3f}" for n, v in zip(LOSS_NAMES, mean_items))
                      + (f" mAP50-95={results.get('metrics/mAP50-95(B)', 0):.4f}" if results else ""))
        finally:
            if transforms is not None:
                data_iter.close()  # stops the loader's threads
        # hand back: EMA parameters + live BN statistics into the facade
        with torch.no_grad():
            sd = {k: v.detach() for k, v in model.state_dict().items()}
            sd.update(state.ema_params)
            dev = next(self.yolo.model.parameters()).device
            self.yolo.model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
        self.state = state
        return results if transforms is not None else dict(zip(LOSS_NAMES, mean_items.tolist()))

    def validate(self, model: torch.nn.Module, state: TrainState) -> Dict[str, float]:
        """The validator on the EMA parameters with the live BN statistics, at batch min(batch, 8);
        the dataset's images read as in training (`cache`)."""
        from .validator import Validator

        ema = copy.deepcopy(model)
        for p in ema.parameters():
            p.grad = None
        with torch.no_grad():
            ema.load_state_dict(state.ema_params, strict=False)
        validator = Validator(self.yolo, imgsz=self.imgsz, batch=min(self.batch, 8), max_gt=self.max_gt,
                              workers=self.workers, cache_images=self.cache, device=self.device)
        self.validator = validator
        return validator(self.data, model=ema.eval())
