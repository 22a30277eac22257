"""The format benchmark and the serving profile (counterpart of `lpc_yolo_tpu/utils/benchmarks.py`; reference
utils/benchmarks.py).

`benchmark` exports the model to each format and gives one row a format with the JAX keys (`format`,
`status`, `size_mb`, `ms/img`, `mAP50-95`); a format that cannot be made here reads `skipped: <reason>`
(NotImplementedError, ImportError, ValueError), any other failure `error: ...`. Each artifact is loaded back
by its runtime (`nn/autobackend.py`) and run once, so "ok" means the artifact runs: the ONNX row needs OpenCV's
dnn module, a CPU runtime, so it runs on the CPU whatever the model's device and its status says so
("ok (cv2.dnn on the CPU)"); it reads `skipped` where OpenCV is not installed. `ms/img` is timed for `ckpt`, which is the port's
serving path (`profile_forward`), and for `torchscript`, in the place of the JAX `stablehlo` row: the
artifact that the package's own runtime runs. Both are device times on the card (CUDA events); on the CPU they
are not measured (None).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils import resolve_device


def cuda_best_ms(step: Callable[[], object], iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """The best of `repeats` runs of `iters` calls of `step`, timed by CUDA events, in ms a call."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _row_times(ms: float, batch: int, imgsz: int) -> Dict[str, float]:
    return {"ms/img": ms / batch, "img/s": 1e3 * batch / ms, "batch": batch, "imgsz": imgsz}


def profile_forward(yolo, imgsz: int = 640, batch: int = 1, iters: int = 10) -> Dict[str, float]:
    """Steady-state latency of the port's serving path on the card: the letterbox kernel on (batch, imgsz,
    imgsz, 3) uint8 frames already on the card, the bf16 BN-folded serving copy (its 3x3 sites on the conv3x3
    kernel) and the decode. The frame is letterboxed to uint8 and cast to bf16, 0..255, as `Predictor.preprocess`
    gives it: the serving copy has /255 folded into its stem. CUDA events after a warm-up, the best of 3 runs of
    `iters` steps. Raises without a card: a device time is never taken on the CPU."""
    from ..engine.predictor import Predictor
    from ..ops.letterbox import letterbox

    dev = resolve_device("cuda")
    pred = Predictor(yolo.model, imgsz=imgsz, batch=batch, device=dev, dtype=torch.bfloat16)
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8))
    frames = frames.to(dev)
    x = torch.empty((batch, imgsz, imgsz, 3), dtype=torch.uint8, device=dev)

    def step():
        letterbox(frames, imgsz, out=x)
        return pred.model.predict(x.permute(0, 3, 1, 2).to(pred.dtype), pred.max_det, pred.conf, pred.iou)

    with torch.inference_mode():
        return _row_times(cuda_best_ms(step, iters), batch, imgsz)


def profile_torchscript(path: str, imgsz: int = 640, batch: int = 1, iters: int = 10) -> Dict[str, float]:
    """The TorchScript artifact's forward on the card (`torch.jit.load(map_location="cuda")`), on an f32 NCHW
    batch already there; timed as `profile_forward`."""
    dev = resolve_device("cuda")
    mod = torch.jit.load(path, map_location=dev).eval()
    x = torch.rand((batch, 3, imgsz, imgsz), generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.inference_mode():
        return _row_times(cuda_best_ms(lambda: mod(x), iters), batch, imgsz)


def benchmark(yolo, data: Optional[str] = None, imgsz: int = 640, formats: Optional[List[str]] = None,
              out_dir: str = "runs/benchmark", verbose: bool = True) -> List[Dict]:
    """Export to each format (every one of `EXPORT_FORMATS` by default) and give its row: size, the artifact
    loaded back and run once, `ms/img` on the card for ckpt and torchscript, and with `data` the ckpt row's
    `YOLO.val` mAP50-95 (JAX :70-107)."""
    from ..engine.exporter import EXPORT_FORMATS, export_model
    from ..nn.autobackend import AutoBackend

    device = torch.device(yolo.device)
    on_card = device.type == "cuda"
    rows: List[Dict] = []
    for fmt in formats or list(EXPORT_FORMATS):
        row = {"format": fmt, "status": "ok", "size_mb": None, "ms/img": None, "mAP50-95": None}
        try:
            path = Path(export_model(yolo, fmt=fmt, imgsz=imgsz, out_dir=out_dir))
            size = sum(f.stat().st_size for f in path.rglob("*")) if path.is_dir() else path.stat().st_size
            row["size_mb"] = round(size / 1e6, 2)
            if fmt == "onnx":
                AutoBackend(path, imgsz=imgsz, device="cpu").warmup()
                row["status"] = "ok (cv2.dnn on the CPU)"
            if fmt == "torchscript":
                AutoBackend(path, imgsz=imgsz, device=device).warmup()
            if on_card and fmt == "ckpt":
                row["ms/img"] = profile_forward(yolo, imgsz=imgsz, batch=1, iters=5)["ms/img"]
            if on_card and fmt == "torchscript":
                row["ms/img"] = profile_torchscript(str(path), imgsz=imgsz, batch=1, iters=5)["ms/img"]
            if data is not None and fmt == "ckpt":
                res = yolo.val(data=data, imgsz=imgsz)
                row["mAP50-95"] = round(res.get("metrics/mAP50-95(B)", 0.0), 4)
        except (NotImplementedError, ImportError, ValueError) as e:
            row["status"] = f"skipped: {e}"
        except Exception as e:  # noqa: BLE001 - the table reports each format's failure
            row["status"] = f"error: {type(e).__name__}: {e}"
        rows.append(row)
        if verbose:
            print(row)
    return rows
