"""The cost of the NMS pool's exact `lax.top_k` order on the card (PyTorch/CUDA port).

    python3 tools/time_nms_pool.py

Two ways to rank the candidates that `ops/nms.py::top_candidates` keeps:
`topk` (`torch.topk`, which orders tied scores in no set way) and `sort` (the
port's `top_k`: a stable descending sort of the whole row, then its first k,
`lax.top_k`'s order). For each: `candidate_pool` at b32 on yolov8n's bf16
serving maps of 720p frames at 640 (8400 anchors, nc 80; multi_label, as
validation calls it, over 672,000 scores a row, and one label an anchor, as
predict calls it), device time from CUDA graphs; then `YOLO.val(data=...)` of
yolov8n and yolov8x on phase 7's 64 frames of `chip_smoke.py` at b32 bf16,
img/s over the wall clock, the two in the order topk, sort, sort, topk, topk,
sort and the median of each kept. Prints the card's name and power limit and
one JSON line; writes chiprun_out/time_nms_pool.json.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from lpc_yolo_tpu_torch.ops import nms  # noqa: E402

PORT = nms.top_k
VARIANTS = {"topk": lambda x, k: x.topk(min(k, x.shape[1]), 1), "sort": PORT}


def serving_preds(B: int = 32, S: int = 640):
    """yolov8n's decoded (B, 8400, 84) predictions from its bf16 serving copy, seed-0 weights, B 720p frames."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import letterbox_batch, serving_model
    from lpc_yolo_tpu_torch.nn.heads import decode_feats

    model = serving_model(YOLO("yolov8n.yaml", device="cuda", seed=0).model, torch.device("cuda"), torch.bfloat16)
    with torch.inference_mode():
        x = letterbox_batch(cs.frames_720p(B, seed=71), S, torch.device("cuda"), torch.uint8, scaleup=False)
        out = model(x.permute(0, 3, 1, 2).to(torch.bfloat16))
        return decode_feats(out, model.strides, model.nc, model.reg_max).float().clone()


def time_pools(pred):
    out = {}
    for multi in (True, False):
        row = {}
        for name, fn in VARIANTS.items():
            nms.top_k = fn
            row[name] = cs.graph_ms(lambda: nms.candidate_pool(pred, 4096, multi_label=multi))
        nms.top_k = PORT
        out["multi_label" if multi else "best_class"] = row
        cs.log("pool", f"candidate_pool b{pred.shape[0]} multi_label={multi}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()) + " (CUDA graphs)")
    return out


def time_val(val_data: Path, n_frames: int):
    from lpc_yolo_tpu_torch import YOLO

    out = {}
    for model in ("yolov8n.yaml", "yolov8x.yaml"):
        yolo, runs = YOLO(model, device="cuda", seed=0), {k: [] for k in VARIANTS}
        yolo.val(data=str(val_data), imgsz=640, batch=cs.VAL_BATCH, cache_images="disk")  # warm: the kernels' build
        for name in ("topk", "sort", "sort", "topk", "topk", "sort"):
            nms.top_k = VARIANTS[name]
            t0 = time.perf_counter()
            yolo.val(data=str(val_data), imgsz=640, batch=cs.VAL_BATCH, cache_images="disk")
            torch.cuda.synchronize()
            runs[name].append(n_frames / (time.perf_counter() - t0))
        nms.top_k = PORT
        out[Path(model).stem] = row = {k: {"img_s": float(np.median(v)), "runs": v} for k, v in runs.items()}
        cs.log("val", f"{Path(model).stem} val b{cs.VAL_BATCH} bf16, {n_frames} frames: " + ", ".join(
            f"{k} {v['img_s']:.1f} img/s" for k, v in row.items()))
        del yolo
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_nms_pool: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    from lpc_yolo_tpu_torch import YOLO

    report = {"card": smi, "pool": time_pools(serving_preds())}
    with tempfile.TemporaryDirectory(prefix="time_nms_pool_") as tmp:
        val_data, _, frames, _ = cs.labelled_val_set(Path(tmp) / "val", YOLO(cs.YAML, device="cuda", seed=0))
        report["val"] = time_val(val_data, len(frames))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "time_nms_pool.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
