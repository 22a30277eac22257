"""Training loop over an iterable of host batches.

Counterpart of the step loop of `lpc_yolo_tpu/engine/trainer.py` (:302-339)
and its hand-back (:412-418): after the last step the facade holds the EMA
parameters with the live BatchNorm statistics. Batches come in the loader's
format: `img` uint8 BGR (B, H, W, 3), `cls` (B, M) int32, `bboxes` (B, M, 4)
xyxy pixels, `mask` (B, M) bool. Like the JAX trainer on its accelerator
(:325), this one ships `img` width-packed x8, (B, H, W/8, 24), when W % 8 == 0
and C == 3: a free reshape on the host, which the step unpacks on the device
through the repack kernel.

Not ported yet: dataset paths and the data pipeline, checkpoints and resume,
callbacks, the results CSV, early stopping, autobatch and validation.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Iterable, List, Mapping, Union

import numpy as np
import torch

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
    """`Trainer(yolo, batches, epochs=...).train()` runs epochs x len(batches) steps."""

    def __init__(self, yolo, batches: Iterable[Mapping[str, Any]], epochs: int = 100, lr0: float = 0.01,
                 lrf: float = 0.01, momentum: float = 0.937, weight_decay: float = 5e-4,
                 warmup_epochs: float = 3.0, optimizer: str = "auto",
                 device: Union[str, torch.device, None] = None):
        self.yolo, self.epochs = yolo, epochs
        self.batches = batches if hasattr(batches, "__len__") else list(batches)
        self.device = resolve_device(device or yolo.device)
        steps_per_epoch = max(len(self.batches), 1)
        total_steps = steps_per_epoch * epochs
        if optimizer == "auto":  # the reference's rule: AdamW for short runs on few classes
            optimizer = "adamw" if total_steps <= 10000 and yolo.model.nc <= 20 else "sgd"
        if optimizer != "sgd":
            raise NotImplementedError(f"optimizer {optimizer!r} is not ported; pass optimizer='sgd'")
        self.cfg = OptConfig(lr0=lr0, lrf=lrf, momentum=momentum, weight_decay=weight_decay,
                             warmup_steps=max(int(warmup_epochs * steps_per_epoch), 100),
                             total_steps=total_steps, optimizer=optimizer)
        self.history: List[Dict[str, Any]] = []  # per step: loss, items, lr, skipped, seconds
        self.state: TrainState = None

    def train(self) -> Dict[str, float]:
        # train a copy: the facade's model stays as it is until the hand-back
        model = copy.deepcopy(self.yolo.model)
        state = init_train_state(model, self.cfg, self.device)
        train_step = make_train_step(model, self.cfg, loss_kind=self.yolo.task)
        mean_items = np.zeros(6)  # of the last epoch
        for epoch in range(self.epochs):
            mean_items[:] = 0
            n_skipped = 0
            for batch in self.batches:
                t0 = time.perf_counter()
                host_batch = {k: batch[k] for k in ("img", "cls", "bboxes", "mask")}
                host_batch["img"] = pack_img(host_batch["img"])
                state, metrics = train_step(state, host_batch)
                items = metrics["items"].cpu().numpy()
                mean_items += items / max(len(self.batches), 1)
                n_skipped += int(metrics["skipped"])
                self.history.append({"epoch": epoch, "loss": float(metrics["loss"]), "items": items.tolist(),
                                     "lr": metrics["lr"], "skipped": metrics["skipped"],
                                     "seconds": time.perf_counter() - t0})
            if n_skipped:
                print(f"WARNING: {n_skipped}/{len(self.batches)} steps skipped (non-finite loss/grads)")
            print(f"epoch {epoch + 1}/{self.epochs} "
                  + " ".join(f"{n}={v:.3f}" for n, v in zip(LOSS_NAMES, mean_items)))
        # hand back: EMA parameters + live BN statistics into the facade
        with torch.no_grad():
            sd = {k: v.detach() for k, v in model.state_dict().items()}
            sd.update(state.ema_params)
            dev = next(self.yolo.model.parameters()).device
            self.yolo.model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
        self.state = state
        return dict(zip(LOSS_NAMES, mean_items.tolist()))
