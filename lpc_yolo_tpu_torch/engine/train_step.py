"""The training step: loss, gradients, SGD with Nesterov momentum or AdamW, EMA, BN statistics.

Counterpart of `lpc_yolo_tpu/engine/train_step.py` (config and schedules
:43-74, optimizer :86-105, state :108-123, the step :126-311; reference
engine/trainer.py:362-394, :695-756, torch_utils.py:431-465 ModelEMA), for
the v10 dual-assignment loss of a v10Detect model, the v8 loss of a Detect
model and of a YOLO-World model (its class maps the similarities with a
text table), the v8 segmentation loss of a Segment model, the v8 pose loss of
a Pose model, the v8 oriented-box loss of an OBB model and the DETR loss of
an RT-DETR model (`loss_kind`, :178-258; a segment batch carries its instance
masks under "masks", a pose batch its keypoints under "keypoints", an OBB
batch its rotated boxes under "rboxes").

In PyTorch's idiom the model's parameters and BatchNorm buffers are the live
state and are updated in place; `TrainState` names them beside the momentum
trace and the EMA copy. The optimizer is written out over `torch._foreach_*`
because its order differs from `torch.optim.SGD` + `clip_grad_norm_`: clip by
the global norm (`g * clip / norm` only when `norm >= clip`), then add
`weight_decay * p` to the kernels only, after the clip, then the Nesterov
trace with the warmed-up momentum, then `-lr`. AdamW follows `optax.adamw`
in the same chain (:86-92): after the clip, Adam's moments in f32 with b1 =
momentum, b2 = 0.999, eps = 1e-8 and the bias correction counted from 1,
then `weight_decay * p` added to the kernels' update, then `-lr` (so
the decay is scaled by the learning rate). The kernels are the parameters
whose JAX leaf is named `kernel` (`utils/flax_bridge.py::is_flax_kernel`,
the JAX `_decay_mask`): conv and Linear weights and flax attention's 3-D
kernels, not the attention's (nh, hd) biases nor RT-DETR's
`denoising_class_embed`. A parameter without a gradient (the layer nothing
reads) counts as a zero gradient, so its kernels still decay. Both
schedules are read at the optimizer's own count, which starts at 0 (the
first update moves no parameter) and does not advance on a skipped step.

A non-finite loss or gradient skips the whole update: parameters, momentum,
BN statistics and EMA keep their values and `step` still counts. The flag
costs one host sync per step, as the JAX trainer fetches its metrics every
step. On the card the forward runs under bf16 autocast with f32 parameters;
the loss is always f32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..losses import rtdetr_loss, v8_detection_loss, v8_obb_loss, v8_pose_loss, v8_segmentation_loss, v10_detect_loss
from ..losses.detr import dn_generator, normalized_cxcywh
from ..utils import resolve_device
from ..utils.flax_bridge import is_flax_kernel


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The reference's train-hyp keys (cfg/default.yaml)."""

    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_steps: int = 1000  # the reference's ~3 warmup epochs, in steps
    warmup_momentum: float = 0.8
    total_steps: int = 100_000
    grad_clip: float = 10.0
    optimizer: str = "sgd"  # 'sgd' | 'adamw'
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0


def _clip01(x: float) -> float:
    return min(max(x, 0.0), 1.0)


def linear_lf(step: int, cfg: OptConfig) -> float:
    """Linear 'one_cycle=False' schedule: lf goes 1 -> lrf over total_steps."""
    frac = _clip01(step / max(cfg.total_steps, 1))
    return (1.0 - frac) * (1.0 - cfg.lrf) + cfg.lrf


def lr_at(step: int, cfg: OptConfig) -> float:
    """Warmup (linear from 0) times the linear decay schedule."""
    return cfg.lr0 * _clip01(step / max(cfg.warmup_steps, 1)) * linear_lf(step, cfg)


def momentum_at(step: int, cfg: OptConfig) -> float:
    warm = _clip01(step / max(cfg.warmup_steps, 1))
    return cfg.warmup_momentum + (cfg.momentum - cfg.warmup_momentum) * warm


@dataclasses.dataclass
class TrainState:
    """Names for the training state. `params` and `batch_stats` are the model's
    own tensors (live, updated in place); `momentum` (the SGD trace, or
    AdamW's first moment), `nu` (AdamW's second moment; empty for SGD) and
    `ema_params` are keyed like `params` (state_dict names)."""

    step: int  # every call of the step, skipped ones included
    opt_step: int  # updates applied: the count both schedules are read at
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]  # BN running_mean / running_var
    momentum: Dict[str, torch.Tensor]
    ema_params: Dict[str, torch.Tensor]
    ema_updates: int
    nu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def init_train_state(model: torch.nn.Module, cfg: OptConfig,
                     device: Union[str, torch.device, None] = None) -> TrainState:
    """Move `model` to the device (CUDA unless device="cpu") in train mode and
    name its state; the moments start at zero, the EMA at the parameters."""
    device = resolve_device(device)
    model.to(device).train()
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    params = dict(model.named_parameters())
    stats = {k: b for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    return TrainState(
        step=0, opt_step=0, params=params, batch_stats=stats,
        momentum={k: torch.zeros_like(p) for k, p in params.items()},
        ema_params={k: p.detach().clone() for k, p in params.items()},
        ema_updates=0,
        nu={k: torch.zeros_like(p) for k, p in params.items()} if cfg.optimizer == "adamw" else {},
    )


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or CPU tensors) on `device`; on the card the
    copies leave from pinned memory and do not block the host."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


@functools.lru_cache(maxsize=8)
def decayed(names_and_shapes: Tuple[Tuple[str, Tuple[int, ...]], ...]) -> Tuple[int, ...]:
    """The positions of the weight-decayed parameters among (state_dict name, shape) pairs."""
    return tuple(i for i, (name, shape) in enumerate(names_and_shapes) if is_flax_kernel(name, len(shape), shape))


@torch.no_grad()
def apply_update(state: TrainState, grads: List[torch.Tensor], gnorm: torch.Tensor, cfg: OptConfig) -> None:
    """One optimizer + EMA update in place, from gradients in `state.params` order
    (overwritten) and their global norm: the optax chain of the JAX package
    (`train_step.py:86-105`) and its ModelEMA (:288-293)."""
    names = list(state.params)
    params = [state.params[k] for k in names]
    lr = lr_at(state.opt_step, cfg)
    torch._foreach_mul_(grads, cfg.grad_clip / torch.clamp(gnorm, min=cfg.grad_clip))  # clip by the global norm
    kernels = decayed(tuple((k, tuple(p.shape)) for k, p in zip(names, params)))  # the JAX mask's "kernel" leaves
    trace = [state.momentum[k] for k in names]
    if cfg.optimizer == "adamw":
        b1, b2, n = cfg.momentum, 0.999, state.opt_step + 1
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(trace, b1)
        torch._foreach_add_(trace, grads, alpha=1 - b1)  # m = b1 m + (1 - b1) g
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)  # v = b2 v + (1 - b2) g^2
        denom = torch._foreach_div(nu, 1 - b2 ** n)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        grads = torch._foreach_div(trace, 1 - b1 ** n)
        torch._foreach_div_(grads, denom)  # m_hat / (sqrt(v_hat) + eps)
        torch._foreach_add_([grads[i] for i in kernels], [params[i] for i in kernels], alpha=cfg.weight_decay)
    else:
        mu = momentum_at(state.opt_step, cfg)
        torch._foreach_add_([grads[i] for i in kernels], [params[i] for i in kernels], alpha=cfg.weight_decay)
        torch._foreach_mul_(trace, mu)
        torch._foreach_add_(trace, grads)  # t = g + mu * t
        torch._foreach_add_(grads, trace, alpha=mu)  # Nesterov: u = g + mu * t
    torch._foreach_add_(params, grads, alpha=-lr)
    state.opt_step += 1

    # ModelEMA over the parameters only, with the ramped decay
    state.ema_updates += 1
    d = cfg.ema_decay * (1.0 - math.exp(-state.ema_updates / cfg.ema_tau))
    ema = [state.ema_params[k] for k in names]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=1.0 - d)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def make_loss_fn(model: torch.nn.Module, amp: Optional[bool] = None, text=None) -> Callable:
    """`loss_fn(batch, step=0) -> (total, items)` on a device batch: the input handling of
    the JAX step (`train_step.py:142-176`), the forward, the loss of the model's
    head: a v10Detect's dual-assignment loss, 6 items; a Detect's
    `v8_detection_loss` with the top-10 assigner, 3 items (box, cls, dfl), and
    a WorldDetect's too, over the M classes of `text` (1, M, 512), which the
    forward reads broadcast to the batch (zeros of (B, nc, 512) when None,
    what the JAX step gives a World graph, :198-204: ROADMAP Queue 3); a
    Segment's `v8_segmentation_loss`, 4 items (box, seg, cls, dfl); a Pose's
    `v8_pose_loss` with the keypoint shape of the batch's keypoints, 5 items
    (box, pose, kobj, cls, dfl); an OBB's `v8_obb_loss` on the batch's rotated
    boxes, 3 items (box, cls, dfl); an RT-DETR's `rtdetr_loss`, 3 items (cls,
    l1, giou), with the denoising group of the batch's ground truths, its draws
    from the generator of `step` (JAX :178-231).

    uint8 BGR frames become f32 RGB in [0, 1]; the width-packed x8 feed
    (last dimension 24) is unpacked by the repack kernel first. On the card
    the forward runs under bf16 autocast unless amp=False (an f32 forward, for
    comparisons); the loss casts the maps to f32 either way (RT-DETR's whole
    output tree, as the JAX step does).
    """

    table = None if text is None else torch.as_tensor(np.asarray(text, np.float32))

    def loss_fn(batch: Mapping[str, torch.Tensor], step: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        img = batch["img"]
        packed = img.dim() == 4 and img.shape[-1] == 24
        x = model.to_nchw(img, "WPACK" if packed else "NHWC")
        if x.dtype == torch.uint8:
            x = x.flip(1).float().div_(255.0)
        dn = None
        if model.task == "rtdetr":
            dn = {"cls": batch["cls"], "bboxes": normalized_cxcywh(batch["bboxes"].to(x.dtype), x.shape[2:]),
                  "mask": batch["mask"], "generator": dn_generator(step, x.device)}
        txt = None if table is None else table.to(x.device).expand(x.shape[0], -1, -1)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=x.device.type == "cuda" and amp is not False):
            out = model(x, dn=dn, text=txt)
        if model.task == "rtdetr":
            out = {k: v.float() if torch.is_tensor(v) and v.dtype in (torch.bfloat16, torch.float16) else v
                   for k, v in out.items()}
            return rtdetr_loss(out, batch["cls"], batch["bboxes"], batch["mask"], x.shape[2:])
        if model.task == "segment":
            return v8_segmentation_loss(out, batch["cls"], batch["bboxes"], batch["mask"], batch["masks"],
                                        model.strides, model.nc)
        if model.task == "pose":
            kpts = batch["keypoints"]
            return v8_pose_loss(out, batch["cls"], batch["bboxes"], batch["mask"], kpts, model.strides, model.nc,
                                kpt_shape=tuple(kpts.shape[-2:]))
        if model.task == "obb":
            return v8_obb_loss(out, batch["cls"], batch["rboxes"], batch["mask"], model.strides, model.nc)
        if model.task in ("v8", "world"):
            total, items = v8_detection_loss(out, batch["cls"], batch["bboxes"], batch["mask"], model.strides,
                                             out[0][1].shape[1], tal_topk=10)
            return total, torch.stack(list(items))
        return v10_detect_loss(out, batch["cls"], batch["bboxes"], batch["mask"], model.strides, model.nc)

    return loss_fn


def make_train_step(model: torch.nn.Module, cfg: OptConfig, loss_kind: str = "v10",
                    amp: Optional[bool] = None, text=None) -> Callable:
    """Build `step(state, batch) -> (state, metrics)` for a v10Detect model (loss_kind "v10"),
    a Detect model ("v8"), a WorldDetect model ("world": the v8 loss, the class logits from
    `text`, see `make_loss_fn`), a Segment model ("segment"), a Pose model ("pose"), an OBB model ("obb")
    or an RT-DETR model ("rtdetr"; its denoising draws keyed by `state.step`).

    batch = {'img': (B, H, W, 3) uint8 BGR or f32 RGB in [0, 1], or the same
    image width-packed x8 (B, H, W/8, 24); 'cls': (B, M) int; 'bboxes':
    (B, M, 4) xyxy pixels; 'mask': (B, M) bool; for "segment" also 'masks': (B, M, H/4, W/4) uint8,
    for "pose" also 'keypoints': (B, M, K, ndim) f32 pixels, for "obb" also 'rboxes': (B, M, 5) [cx, cy, w,
    h, angle] f32 pixels}, numpy or tensors.
    metrics = {'loss', 'items' (6,) for v10, (3,) for v8, world, obb and rtdetr, (4,) for segment, (5,) for pose,
    'lr', 'skipped'};
    `state` must come from `init_train_state(model, ...)`. amp: see `make_loss_fn`.
    """
    if loss_kind not in ("v10", "v8", "world", "segment", "pose", "obb", "rtdetr"):
        raise NotImplementedError(f"loss_kind {loss_kind!r} is not ported; only 'v10', 'v8', 'world', 'segment', "
                                  f"'pose', 'obb' and 'rtdetr' are")
    if model.task != loss_kind:
        raise ValueError(f"loss_kind {loss_kind!r} does not train this model's head (task {model.task!r})")
    if cfg.optimizer not in ("sgd", "adamw"):
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported; use 'sgd' or 'adamw'")
    loss_fn = make_loss_fn(model, amp, text)
    saved_stats: List[torch.Tensor] = []  # where a skipped step finds the BN statistics it must restore

    def step(state: TrainState, batch: Mapping[str, Any]) -> Tuple[TrainState, Dict[str, Any]]:
        params = list(state.params.values())
        stats = list(state.batch_stats.values())
        batch = to_device(batch, params[0].device)
        if not saved_stats:
            saved_stats.extend(torch.empty_like(s) for s in stats)
        with torch.no_grad():
            torch._foreach_copy_(saved_stats, stats)  # the forward updates them in place

        for p in params:
            p.grad = None
        loss, items = loss_fn(batch, state.step)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        gnorm = global_norm(grads)
        lr = lr_at(state.step, cfg)
        # one host sync: a non-finite gradient makes the global norm non-finite
        finite = bool((torch.isfinite(loss) & torch.isfinite(gnorm)).item())
        state.step += 1
        if finite:
            apply_update(state, grads, gnorm, cfg)
        else:
            with torch.no_grad():
                torch._foreach_copy_(stats, saved_stats)
        return state, {"loss": loss.detach(), "items": items, "lr": lr, "skipped": not finite}

    return step
