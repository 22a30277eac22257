"""The classification task's train step, evaluation and epoch loop.

Counterpart of `lpc_yolo_tpu/engine/classify.py` (`make_cls_train_step`
:26-51, `evaluate_classifier` :55-76, `train_classifier` :79-130; reference
models/yolo/classify/{train,val}.py).

The step takes the loader's NHWC uint8 BGR batch as it is (no width pack,
so no repack), makes it RGB in [0, 1], and minimises the softmax cross
entropy over the batch; the optimizer is the one `init_train_state` names
(`engine/train_step.py::apply_update`: the JAX chain of clip, AdamW with the
decay on the kernels, then the EMA with the ramped decay, :43-45). Unlike the
detection step it has no guard for a non-finite loss, as the JAX step has
none. On the card the forward runs under bf16 autocast; the loss is f32.

`evaluate_classifier` is top-1 and top-5 accuracy over the real rows of each
padded batch (the JAX argsort of each row's probabilities), on the model's
BN-folded serving copy (`engine/predictor.py::serving_model`: its 3x3 s1
convs go through the conv3x3 kernel, /255 folded into the stem), bf16 on the
card. Its labels are the dataset's `names` (see `data/classify.py`).

`train_classifier` runs the JAX epoch loop: AdamW (`OptConfig(optimizer=
"adamw", warmup_steps=max(steps, 20))`), `evaluate_classifier` on the EMA
parameters with the live BatchNorm statistics after every epoch when there
is a val split, `weights/last.ckpt` every epoch (the JAX `TrainState`'s
tree, meta {"epoch"}) and one `results.csv` row (epoch, train/loss, the
metrics, time_s). The model trains as a copy; afterwards the facade holds
the EMA parameters with the live statistics.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..data import ClassificationDataset, ClsTransforms, DataLoader, check_cls_dataset
from ..utils import msgpack, resolve_device
from ..utils.checkpoint import write_checkpoint
from ..utils.flax_bridge import train_state_dict
from .predictor import serving_model
from .train_step import (OptConfig, TrainState, apply_update, global_norm, init_train_state, lr_at, to_device)
from .trainer import append_row, ema_model, hand_back, host_state


def make_cls_train_step(model: torch.nn.Module, cfg: OptConfig) -> Callable:
    """`step(state, batch) -> (state, {"loss", "lr"})` for a Classify model; batch = {'img': (B, H, W, 3)
    uint8 BGR, 'label': (B,) int}, numpy or tensors; `state` from `init_train_state(model, cfg)`. The forward
    runs in the parameters' dtype (f64 for comparisons), under bf16 autocast on the card."""
    if model.task != "classify":
        raise ValueError(f"make_cls_train_step trains a Classify head, not task {model.task!r}")

    def step(state: TrainState, batch: Mapping[str, Any]) -> Tuple[TrainState, Dict[str, Any]]:
        params = list(state.params.values())
        b = to_device(batch, params[0].device)
        x = model.to_nchw(b["img"], "NHWC").flip(1).to(params[0].dtype).div_(255.0)
        for p in params:
            p.grad = None
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=x.device.type == "cuda"):
            logits = model(x)
        loss = F.cross_entropy(logits.to(x.dtype), b["label"].long())
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        lr = lr_at(state.step, cfg)
        state.step += 1
        apply_update(state, grads, global_norm(grads), cfg)
        return state, {"loss": loss.detach(), "lr": lr}

    return step


@torch.inference_mode()
def evaluate_classifier(model: torch.nn.Module, split_dir: Union[str, Path], imgsz: int = 224, batch: int = 32,
                        workers: int = 4, names: Optional[Dict[int, str]] = None,
                        device: Union[str, torch.device, None] = None,
                        cache_images: Union[bool, str] = False) -> Dict[str, float]:
    """Top-1 and top-5 accuracy of `model` on a class-folder split -> {"metrics/accuracy_top1",
    "metrics/accuracy_top5", "fitness"} (fitness is top-1). It runs on the card unless device="cpu", in bf16
    there and f32 on the CPU."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    serving = serving_model(model, device, dtype)
    ds = ClassificationDataset(split_dir, imgsz=imgsz, names=names, cache_images=cache_images)
    loader = DataLoader(ds, ClsTransforms(imgsz), batch_size=batch, workers=workers)
    top1 = top5 = n = 0
    for b in loader:
        img = to_device({"img": b["img"]}, device)["img"]
        probs = serving.predict(img.permute(0, 3, 1, 2).flip(1).to(dtype)).cpu().numpy()
        for j in range(len(probs) - b["pad_count"]):
            order = np.argsort(-probs[j])
            label = b["label"][j]
            top1 += int(order[0] == label)
            top5 += int(label in order[:5])
            n += 1
    return {"metrics/accuracy_top1": top1 / max(n, 1), "metrics/accuracy_top5": top5 / max(n, 1),
            "fitness": top1 / max(n, 1)}


def train_classifier(yolo, data: Union[str, Path], epochs: int = 10, batch: int = 32, imgsz: int = 224,
                     lr0: float = 0.002, workers: int = 4, save_dir: Union[str, Path] = "runs/classify/train",
                     cache_images: Union[bool, str] = False, device: Union[str, torch.device, None] = None,
                     **_) -> Dict[str, float]:
    """Train the facade's Classify model on a class-folder root (`check_cls_dataset`) -> the last epoch's
    evaluation (empty without a val split). Other keyword arguments are ignored, as the JAX loop ignores
    them. `cache_images` reads the images' `.npy` twins (the card's machine has no OpenCV)."""
    info = check_cls_dataset(data)
    if yolo.model.nc != info["nc"]:
        raise ValueError(f"model nc={yolo.model.nc} != dataset nc={info['nc']}; use YOLO(cfg, nc={info['nc']})")
    device = resolve_device(device or yolo.device)
    ds = ClassificationDataset(info["train"], imgsz=imgsz, names=info["names"], cache_images=cache_images)
    loader = DataLoader(ds, ClsTransforms(imgsz, augment=True), batch_size=batch, workers=workers, shuffle=True,
                        infinite=True)
    steps = max(len(loader), 1)
    cfg = OptConfig(lr0=lr0, optimizer="adamw", total_steps=steps * epochs, warmup_steps=max(steps, 20))
    model = copy.deepcopy(yolo.model)
    state = init_train_state(model, cfg, device)
    step_fn = make_cls_train_step(model, cfg)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    results: Dict[str, float] = {}
    it = iter(loader)
    try:
        for epoch in range(epochs):
            t0, mean_loss = time.time(), 0.0
            for _ in range(steps):
                b = next(it)
                state, m = step_fn(state, {"img": b["img"], "label": b["label"]})
                mean_loss += float(m["loss"]) / steps
            if "val" in info:
                results = evaluate_classifier(ema_model(model, state), info["val"], imgsz, batch, workers,
                                              names=info["names"], device=device, cache_images=cache_images)
            blob = msgpack.to_bytes(train_state_dict(host_state(state), cfg))
            write_checkpoint(save_dir / "weights" / "last.ckpt", blob, {"epoch": epoch})
            append_row(save_dir / "results.csv", {"epoch": epoch, "train/loss": round(mean_loss, 5),
                                                  **{k: round(v, 5) for k, v in results.items()},
                                                  "time_s": round(time.time() - t0, 1)})
            print(f"epoch {epoch + 1}/{epochs} loss={mean_loss:.4f} "
                  + (f"top1={results.get('metrics/accuracy_top1', 0):.3f}" if results else ""))
    finally:
        it.close()  # stops the loader's threads
    hand_back(yolo, model, state)
    return results
