#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`lpc_yolo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --conv3x3    # device, build, then conv3x3 parity and per-shape times only
    python3 chip_smoke.py --converge   # device, build, then the learning proof only (see the end)

Phases, in order; any failure raises and the script exits non-zero:

1. device   the card's name and power limit; TF32 off for the parity phases.
2. build    the three hand-written kernels (csrc/*.cu) with nvcc, in parallel.
3. parity   each kernel against its plain PyTorch version on the card at the
            main path's shapes: letterbox (720x1280, 1080x810 -> 640, batch 4,
            u8/f32/bf16), conv3x3 (every distinct LPC-YOLO 3x3 s1 conv site at
            batch 2, f32 and bf16, with the input strides the site gets: the
            first bottleneck of each C2f reads the upper channel half of a
            channels_last map as a strided view), repack (bit-exact: the
            training feed (16|32, 640, 80, 24) u8 8->1, the JAX test's
            (1, 4, 4, 24) f32 4->2, 4->1, 2->1, an activation-sized
            (32, 320, 80, 192) 4->2 in f32 and bf16, and [:, :h, :w] slices of
            larger buffers).
4. slice    YOLO(LPC-YOLO yaml, seed 0).predict on 9 seeded BGR frames at
            640, batch 4, bf16, with the kernels' launch counters reset just
            before and read just after; then a (B, 300, 6) finite check; the
            bf16 serving path against the f32 plain path (plain letterbox,
            unfolded model): one2one maps within a centred relative error,
            sorted scores within 1e-2, and every conv3x3 site's output against
            the plain version on that site's own inputs; and the same frames in
            f32 through the kernel path and through the plain path, compared
            tie-tolerantly.
5. times    the serving step at b32 from 720p frames (CUDA events, and a
            torch.profiler breakdown by kernel with the device's idle share),
            and each kernel at its main-path shapes beside its bound, its
            plain version and the library call: device times from CUDA graphs
            of 20 calls, so without the host's launch cost (conv3x3 per shape;
            letterbox and repack on a cold L2, their inputs rotating through
            enough buffers and every output kept, with a real copy of the same
            bytes as the repack's library call), and eager calls beside them.
6. train    YOLO(LPC-YOLO yaml, seed 0).train(batches=...) on seeded uint8
            batches at 640, batch 16, bf16 autocast, with the launch counters
            reset just before and read just after: every loss finite, no step
            skipped, one repack launch per step, parameters, BN statistics and
            EMA moved; one f32 step on the card against the same step on the
            CPU (batch 2, loss items rtol 1e-3); the step's time (CUDA
            events), peak memory and a profiler breakdown; then YOLO.predict
            on the trained facade through the letterbox and conv3x3 kernels.
7. val      the letterbox kernel on the validator's scaleup=False tables
            against its plain version (u8, bit-exact); then YOLO.val(data=...)
            at 640, batch 32, from 64 frames written to a temp dir (720x1280,
            1080x810 and 360x480, as PNGs with .npy twins, read through
            cache_images="disk"; labels from the port's own f32 detections),
            in f32 and bf16, with the launch counters reset just before and
            read just after each run (a letterbox per batch and frame shape,
            28 conv3x3 per batch); f32 on the card against the CPU on 8 frames
            (every metric within 0.02); bf16 finite, its mAP50 within 0.35 of
            f32's; img/s from the files on disk, the speed split per image,
            and one b32 batch's device time.
8. train_data  YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=...) on a
            synthetic dataset written to a temp dir (64 train frames of the
            three val shapes with 1 to 6 rectangles each, 16 val frames, PNG +
            .npy twins, cache="disk"): 3 epochs at 640, batch 16, optimizer
            "auto" (AdamW), the last epoch letterboxed (close_mosaic=1), the
            batches rendered on the card, with the launch counters reset just
            before and read just after: every loss finite, no step skipped,
            one repack launch per step, a letterbox per val batch and frame
            shape and 28 conv3x3 per val batch for the three validations. Then
            the trainer's loader with 8 and with 1 worker (same frames and
            labels), the card's render against the CPU render of the same
            plans (within 1 LSB), the render's device time and launches, the
            loader's host ms and the H2D bytes per batch; one f32 AdamW step
            on the card against the CPU (batch 2, loss items rtol 1e-3) and
            three AdamW updates on the same seeded gradients (parameters,
            moments and EMA within 2e-6 of each leaf's largest value); img/s,
            input_wait_frac and render_frac of the run.
9. ckpt     YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=..., save=True) on
            phase 8's dataset, 3 epochs, with the launch counters reset just
            before and read just after (a letterbox per val batch and frame
            shape, 28 conv3x3 per val batch, a repack per step): its
            weights/last.ckpt and best.ckpt and a results.csv of 3 rows;
            last.ckpt read back into a card TrainState equal to the trainer's
            final state bit for bit (parameters, BN statistics, moments, EMA,
            counters); a run stopped by SIGTERM in the first step of epoch 2
            and resumed with resume=True runs epochs 2 and 3 once each from
            the saved counters and ends within 1e-3 of each leaf's largest
            value of the uninterrupted run's state; YOLO.save -> YOLO(path, device="cuda") ->
            predict gives the saved model's detections. The seconds of each
            checkpoint write and read and the file's size.

The line before last is a JSON object with one entry per kernel (three; launches
from phase 9); the last line is {"ok": true, "device": {...}}. Every number is
also written to chiprun_out/chip_smoke.json.

`--converge` runs tools/train_convergence.py's learning proof on the card
instead of the phases: LPC-YOLO with nc=3 on the synthetic set of 256 + 32
frames at 160, 120 epochs of b16 (close_mosaic 40, max_gt 8, cache="ram",
val=False, save=True), then `val` at f32 and at bf16 on the trained weights
reloaded through YOLO.save -> YOLO(path); it prints mAP50, mAP50-95, the
bf16 - f32 gap and the seconds, writes chiprun_out/chip_smoke_converge.json
and exits non-zero when mAP50 <= 0.5 (the JAX slow test's bar).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
YAML = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM HBM3, bytes per ms
BF16_FLOPS_PER_MS = 989e12 / 1e3  # dense bf16 tensor-core peak
F32_FLOPS_PER_MS = 67e12 / 1e3  # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20  # H100 L2 cache
CONV_SITES_PER_FORWARD = 28  # 3x3 s1 g1 convs on the one2one serving path (layer 27 is dead)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_GT = 16, 6, 8  # the JAX trainer's default batch; gts padded to 8 per image
BF16_MAP_TOL = 0.25  # ||bf16 - f32|| / ||f32 - its spatial mean|| per one2one map
BF16_SCORE_TOL = 1e-2  # sorted top-300 scores, bf16 serving path vs f32 plain path
VAL_SHAPES = ((720, 1280), (1080, 810), (360, 480))  # two downscaled by the letterbox, one only padded (scaleup=False)
VAL_FRAMES, VAL_BATCH, VAL_SUBSET, VAL_UNLABELLED = 64, 32, 8, 5  # every 5th frame has no label file
VAL_F32_TOL = 0.02  # every key of the results dict, f32 on the card vs the CPU: near-tied scores may swap places
VAL_BF16_MAP50_TOL = 0.35  # mAP50, bf16 vs f32: the random weights' scores cluster within ~1e-3, bf16 reorders them
TD_TRAIN, TD_VAL, TD_BATCH, TD_EPOCHS = 64, 16, 16, 3  # train(data=...): 4 steps an epoch, validation at batch 8
CONV_EPOCHS, CONV_MAP50_BAR = 120, 0.5  # --converge: tools/train_convergence.py's run, the JAX slow test's bar
RESUME_TOL = 1e-3  # a resumed run's state against the uninterrupted run's, of each leaf's largest value
REPORT = {}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 3) -> float:
    """Median over `repeats` of the mean time per call over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def graph_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and replayed, so the host's
    cost of launching each call (Python, ctypes, PyTorch's dispatch) is left out. Median of
    `repeats` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=1, warmup=1, repeats=repeats) / iters
    del graph
    return ms


def cold_graph_ms(fn, arg_sets, bytes_per_set: int, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call of `fn(*arg_sets[i % k])`, from a CUDA graph of `iters` calls (as
    `graph_ms`) whose inputs and outputs are out of the L2 cache at every call: the k = len(arg_sets)
    input sets rotate, at least 2 L2 sizes of other input apart, and every call's output is kept
    alive in the graph's pool, so no call writes into a buffer that an earlier call left in L2."""
    assert (len(arg_sets) - 1) * bytes_per_set >= 2 * L2_BYTES, "too few input sets to leave L2 cold"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(iters):
            outs.append(fn(*arg_sets[i % len(arg_sets)]))
    ms = cuda_ms(graph.replay, iters=1, warmup=1, repeats=repeats) / iters
    del graph, outs
    torch.cuda.empty_cache()
    return ms


def n_cold_sets(bytes_per_set: int) -> int:
    """Input sets `cold_graph_ms` needs: consecutive uses of one set at least 2 L2 sizes apart."""
    return max(2, 1 + -(-2 * L2_BYTES // bytes_per_set))


def profile_step(step, iters: int = 3):
    """Device time by kernel over `iters` steps (torch.profiler), and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows, sync_ms = [], 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append({"kernel": e.key[:90], "ms_per_step": us / 1e3 / iters, "calls_per_step": e.count / iters})
        elif e.key == "aten::_local_scalar_dense":  # the host blocked in .item(): waiting for the device to catch up
            sync_ms = e.cpu_time_total / 1e3 / iters
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms if rows else None,
            "device_launches": sum(r["calls_per_step"] for r in rows), "host_sync_wait_ms": sync_ms, "top": rows[:15]}


def bound(nbytes: float, flops: float, flops_per_ms: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / flops_per_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    REPORT["device"] = {"name": name, "nvidia_smi": smi}
    return name, smi


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each kernel in nvcc's -Xptxas -v output,
    with template arguments spelled out (conv3x3_bf16_mma<16,16,64,32,2,64,32>)."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled, pos, parts = m.group(1), 0, []
            if mangled.startswith("_Z"):  # <length><identifier> pieces of the nested name
                pos = 3 if mangled.startswith("_ZN") else 2
                while pos < len(mangled) and mangled[pos].isdigit():
                    n = re.match(r"\d+", mangled[pos:]).group(0)
                    parts.append(mangled[pos + len(n):pos + len(n) + int(n)])
                    pos += len(n) + int(n)
            name = next((p for p in reversed(parts) if not p.startswith("_GLOBAL__N")), mangled)
            if mangled[pos:pos + 1] == "I":
                name += f"<{','.join(re.findall(r'Li(\d+)E', mangled))}>"
            cur = {"kernel": name}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def phase_build():
    from lpc_yolo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    REPORT["ptxas"] = {}
    for name in _build.KERNELS:
        _build.load(name)
        REPORT["ptxas"][name] = ptxas_report(_build.build_logs.get(name, ""))
        for r in REPORT["ptxas"][name]:
            log("build", f"{name}: {r['kernel']}: {r.get('registers')} registers, static smem {r.get('static_smem')} B, "
                         f"spill stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")
    log("build", f"built {[p.name for p in paths]} in {secs:.1f} s")
    REPORT["build_s"] = secs


def frames_720p(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


def phase_parity_letterbox():
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    worst = {}
    rng = np.random.default_rng(1)
    for h0, w0 in ((720, 1280), (1080, 810)):
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        tab = tables_on(h0, w0, 640, frames.device)
        content = ((tab[0] >= 0)[:, None] & (tab[4] >= 0)[None, :]).cpu()
        for dt in (torch.uint8, torch.float32, torch.bfloat16):
            got = letterbox(frames, 640, out_dtype=dt)
            ref = letterbox_plain(frames, tab, 640, dt)
            torch.cuda.synchronize()
            if dt == torch.uint8:
                err = (got.int() - ref.int()).abs().max().item()
                pad_ok = bool((got.cpu()[:, ~content] == 114).all())
                assert err <= 1 and pad_ok, f"letterbox u8 {h0}x{w0}: max {err} LSB, pad exact {pad_ok}"
            elif dt == torch.float32:
                err = (got - ref).abs().max().item()
                assert err <= 1e-5, f"letterbox f32 {h0}x{w0}: max abs err {err}"
            else:
                err = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
                assert err <= 1, f"letterbox bf16 {h0}x{w0}: {err} ulp"
            worst[str(dt).split(".")[-1]] = max(worst.get(str(dt).split(".")[-1], 0), err)
    log("parity", f"letterbox vs plain (u8 LSB / f32 abs / bf16 ulp): {worst}")
    REPORT["letterbox_parity"] = worst
    return worst["float32"]


def strided_slice(shape, dtype, g):
    """A (B, H, Wf, K) input that is a [:, :H, :Wf] slice of a larger buffer: strided in B and H."""
    B, H, Wf, K = shape
    big = torch.randint(0, 256, (B, H + 32, Wf + 4, K), device="cuda", generator=g, dtype=torch.uint8) \
        if dtype == torch.uint8 else torch.randn(B, H + 32, Wf + 4, K, device="cuda", generator=g).to(dtype)
    return big[:, :H, :Wf]


def phase_parity_repack():
    from lpc_yolo_tpu_torch.ops.repack import repack_width, repack_width_kernel, repack_width_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []  # (input, p_from, p_to)
    for B in (16, 32):  # the training feed: width-packed x8 uint8 frames
        cases.append((torch.randint(0, 256, (B, 640, 80, 24), device="cuda", generator=g, dtype=torch.uint8), 8, 1))
    small = torch.rand(1, 4, 4, 24, device="cuda", generator=g)  # the JAX package's own test shape
    cases += [(small, 4, 2), (small, 4, 1), (repack_width(small, 4, 2), 2, 1)]
    for dt in (torch.float32, torch.bfloat16):  # an activation-sized map
        cases.append((torch.randn(32, 320, 80, 4 * 48, device="cuda", generator=g).to(dt), 4, 2))
    cases += [(strided_slice((16, 640, 80, 24), torch.uint8, g), 8, 1),
              (strided_slice((32, 320, 80, 192), torch.bfloat16, g), 4, 2),
              (strided_slice((2, 30, 7, 12), torch.float32, g), 4, 1)]  # rows of 336 bytes
    n_strided = 0
    for x, pf, pt in cases:
        got, ref = repack_width_kernel(x, pf, pt), repack_width_plain(x, pf, pt)
        torch.cuda.synchronize()
        what = f"{tuple(x.shape)} {x.dtype} {pf}->{pt} strides {x.stride()}"
        assert got.shape == ref.shape and got.is_contiguous(), what
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), f"repack kernel != plain: {what}"
        n_strided += not x.is_contiguous()
        del got, ref
    log("parity", f"repack vs plain: bit-exact on {len(cases)} cases ({n_strided} strided slices), u8 / f32 / bf16")
    REPORT["repack_parity"] = {"cases": len(cases), "strided": n_strided, "max_abs_err": 0.0}
    return 0.0


def conv_sites(pred):
    """(C, H, W, Co, act, pix, off) of each 3x3 s1 g1 conv the serving path runs at 640, in order.

    pix is the input's stride between pixels in elements and off its channel
    offset in that pixel: (C, 0) for a channels_last map, (2C, C) for the upper
    half of a C2f split, which reaches the kernel as a strided view.
    """
    from lpc_yolo_tpu_torch.nn.modules import ConvBN

    def record(mod, inp):
        x = inp[0]
        C, H, W = x.shape[1:]
        pix, off = (x.stride(3), x.storage_offset() % x.stride(3)) if x.stride(1) == 1 else (C, 0)
        sites.append((C, H, W, mod.conv.out_channels, mod.act, pix, off))

    sites = []
    hooks = [m.register_forward_pre_hook(record) for m in pred.model.modules()
             if isinstance(m, ConvBN) and m.kernel_path]
    with torch.inference_mode():
        pred.infer(frames_720p(1, seed=9))
    for h in hooks:
        h.remove()
    return sites


def site_input(shape, n, g, dtype):
    """A (n, H, W, C) NHWC input with the strides of a conv site: a channel slice of an (n, H, W, pix) map."""
    C, H, W, _, _, pix, off = shape
    return torch.randn(n, H, W, pix, device="cuda", generator=g).to(dtype)[..., off:off + C]


def phase_parity_conv(sites):
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    assert len(sites) == CONV_SITES_PER_FORWARD, f"{len(sites)} kernel sites per forward, expected 28"
    worst_f32, worst_bf16 = 0.0, 0.0
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in sorted(set(sites), key=str):
        C, H, W, Co, act, pix, off = shape
        x = site_input(shape, 2, g, torch.float32)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.rand(Co, device="cuda", generator=g) - 0.5
        e32 = (conv3x3(x, w, b, act) - conv3x3_plain(x, w, b, act)).abs().max().item()
        xq, wq = site_input(shape, 2, g, torch.bfloat16), w.bfloat16()  # cast before the slice
        ref = conv3x3_plain(xq.float(), wq.float(), b, act)
        e16 = ((conv3x3(xq, wq, b, act).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        torch.cuda.synchronize()
        where = f"{C}->{Co} at {H}x{W} {act}, pixel stride {pix}, channel offset {off}"
        assert e32 <= 1e-4, f"conv3x3 f32 {where}: max abs err {e32}"
        assert e16 <= 2e-2, f"conv3x3 bf16 {where}: relative err {e16}"
        worst_f32, worst_bf16 = max(worst_f32, e32), max(worst_bf16, e16)
    n_strided = len({s for s in sites if s[5] != s[0]})
    log("parity", f"conv3x3 vs plain on {len(set(sites))} site shapes ({n_strided} strided C2f slices): "
                  f"f32 max abs {worst_f32:.3g} (tol 1e-4), bf16 max rel {worst_bf16:.3g} (tol 2e-2)")
    REPORT["conv3x3_parity"] = {"f32_max_abs": worst_f32, "bf16_max_rel": worst_bf16, "shapes": len(set(sites)),
                                "strided_shapes": n_strided}
    return worst_f32


def bf16_site_errors(pred, frames):
    """Each conv3x3 site of one bf16 serving forward against the plain version
    (f32 on the site's own bf16 inputs and weights): max relative error per site."""
    from lpc_yolo_tpu_torch.nn.modules import ConvBN
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3_plain

    def check(mod, inp, out):
        w, b = mod.folded
        ref = conv3x3_plain(inp[0].permute(0, 2, 3, 1).float(), w.float(), b, mod.act)
        errs.append(((out.permute(0, 2, 3, 1).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item())

    errs = []
    hooks = [m.register_forward_hook(check) for m in pred.model.modules() if isinstance(m, ConvBN) and m.kernel_path]
    with torch.inference_mode():
        pred.infer(frames)
    for h in hooks:
        h.remove()
    return errs


def phase_slice(yolo, pred16):
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    odd = np.random.default_rng(7).integers(0, 256, (1080, 810, 3), dtype=np.uint8)
    f720 = frames_720p(8, seed=3)
    frames = f720[:4] + f720[4:7] + [odd] + f720[7:]  # batches of 4: [4 x 720p], [3 x 720p + odd], [1 x 720p]
    expect_lb, forwards = 1 + 2 + 1, 3

    letterbox.launches = conv3x3.launches = 0
    results = yolo.predict(frames, imgsz=640, batch=4, conf=0.25)
    torch.cuda.synchronize()
    launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches}
    assert len(results) == 9 and results[7].orig_shape == (1080, 810)
    assert launches == {"letterbox": expect_lb, "conv3x3": CONV_SITES_PER_FORWARD * forwards}, launches
    log("slice", f"YOLO.predict: 9 frames, batch 4, bf16 -> {[len(r) for r in results]} boxes above conf 0.25; "
                 f"launches {launches} (expected letterbox {expect_lb}, conv3x3 28 x {forwards})")

    chunk = frames[4:8]  # 3 x 720p + the odd shape
    det16 = pred16.infer(chunk)
    assert det16.shape == (4, 300, 6) and bool(torch.isfinite(det16).all()), "bf16 detections not finite"

    # the plain path: plain letterbox to u8 (the predictor's feed), /255 in f32, unfolded f32 model, no kernel
    x = torch.empty(4, 640, 640, 3, device="cuda")
    for shape in {im.shape for im in chunk}:
        slots = [j for j, im in enumerate(chunk) if im.shape == shape]
        src = torch.from_numpy(np.stack([chunk[j] for j in slots])).cuda()
        x[slots] = letterbox_plain(src, tables_on(*shape[:2], 640, src.device), 640, torch.uint8).float() / 255
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        det_p = yolo.model.predict(x)
        maps_p = yolo.model(x, branches="one2one")["one2one"]
        maps16 = pred16.model(pred16.preprocess(chunk), branches="one2one")["one2one"]

    # bf16 serving path vs f32 plain path: each one2one map's error against its spread over the map
    map_err = max(((a.float() - b).norm() / (b - b.mean((2, 3), keepdim=True)).norm()).item()
                  for pa, pb in zip(maps16, maps_p) for a, b in zip(pa, pb))
    det16, det_p = det16.float().cpu().numpy(), det_p.cpu().numpy()
    score_gap = float(np.abs(np.sort(det16[:, :, 4], 1) - np.sort(det_p[:, :, 4], 1)).max())
    site_err = bf16_site_errors(pred16, chunk)
    assert map_err <= BF16_MAP_TOL, f"bf16 one2one maps off the f32 plain path: centred relative error {map_err}"
    assert score_gap <= BF16_SCORE_TOL, f"bf16 sorted scores off the f32 plain path by {score_gap}"
    assert len(site_err) == CONV_SITES_PER_FORWARD and max(site_err) <= 2e-2, f"bf16 conv3x3 sites: {site_err}"
    log("slice", f"bf16 serving path vs f32 plain path: one2one maps centred relative error {map_err:.3g} "
                 f"(tol {BF16_MAP_TOL}), sorted-score gap {score_gap:.3g} (tol {BF16_SCORE_TOL}); "
                 f"28 conv3x3 sites on their own inputs: max rel {max(site_err):.3g} (tol 2e-2)")

    # f32: kernel path (folded model, both kernels) vs plain path
    det_k = Predictor(yolo.model, imgsz=640, batch=4, device="cuda", dtype=torch.float32).infer(chunk)
    det_k = det_k.cpu().numpy()
    for i in range(4):
        assert_detections_close(det_k[i], det_p[i], atol_box=0.05, atol_score=1e-4)
    log("slice", "(4, 300, 6) finite in bf16; f32 kernel path == plain path (box 0.05 px, score 1e-4)")
    REPORT["slice"] = {"launches": launches, "boxes_per_frame": [len(r) for r in results],
                       "bf16_map_err": map_err, "bf16_score_gap": score_gap, "bf16_site_max_rel": max(site_err)}
    return launches


def phase_times(yolo, sites):
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    B, S = 32, 640
    pred = Predictor(yolo.model, imgsz=S, batch=B, device="cuda", dtype=torch.bfloat16)
    host = frames_720p(B, seed=5)
    dev = torch.from_numpy(np.stack(host)).cuda()
    x = torch.empty(B, S, S, 3, dtype=torch.bfloat16, device="cuda")

    def step():
        letterbox(dev, S, out=x)
        return pred.model.predict(x.permute(0, 3, 1, 2))

    with torch.inference_mode():
        step_ms = cuda_ms(step, iters=5, warmup=2)
        pred.infer(host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pred.infer(host)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
    log("times", f"serving step b{B} 640 bf16 from device-resident 720p frames (letterbox + forward + decode): "
                 f"{step_ms:.3f} ms/batch, {B / step_ms * 1e3:.1f} img/s")
    log("times", f"Predictor.infer b{B} from host numpy frames (stack + H2D + step): {host_ms:.3f} ms/batch, "
                 f"{B / host_ms * 1e3:.1f} img/s")
    REPORT["serving"] = {"batch": B, "step_ms": step_ms, "img_s": B / step_ms * 1e3,
                         "host_infer_ms": host_ms, "host_img_s": B / host_ms * 1e3}
    with torch.inference_mode():
        prof = profile_step(step)
    if prof["top"]:
        log("times", f"profile of the step: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
                     f"idle share {prof['idle_share']:.3f}")
        for r in prof["top"]:
            log("times", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")
    else:
        log("times", "profiler recorded no device time: breakdown not measured")
    REPORT["serving"]["profile"] = prof

    # letterbox at the main path's shape: b32 720p -> 640, bf16 output; device time on a cold L2
    # (rotating frame/output pairs) beside eager calls (host launch cost included)
    tab = tables_on(720, 1280, S, dev.device)
    lb_bytes = dev.numel() + x.numel() * 2 + tab.numel() * 4
    sets = [(dev, x)] + [(torch.randint_like(dev, 0, 256), torch.empty_like(x)) for _ in range(n_cold_sets(lb_bytes) - 1)]
    lb_ms = cold_graph_ms(lambda src, out: letterbox(src, S, out=out), sets, lb_bytes)
    lb_eager = cuda_ms(lambda: letterbox(dev, S, out=x))
    lb_plain = cuda_ms(lambda: letterbox_plain(dev, tab, S, torch.bfloat16), iters=5)
    del sets
    lb_bound, lb_by = bound(lb_bytes, B * S * S * 3 * 9, F32_FLOPS_PER_MS)
    log("times", f"letterbox b{B} 720p->640 bf16: {lb_ms:.4f} ms device time (CUDA graph, cold L2), "
                 f"{lb_eager:.4f} ms eager calls, plain {lb_plain:.4f} ms (eager), bound {lb_bound:.4f} ms ({lb_by}), "
                 f"{lb_bound / lb_ms:.3f} of bound")
    REPORT["letterbox_times"] = {"ms": lb_ms, "eager_ms": lb_eager, "plain_ms": lb_plain, "bound_ms": lb_bound,
                                 "bound_by": lb_by, "bytes": lb_bytes, "cold_sets": n_cold_sets(lb_bytes)}

    return REPORT["letterbox_times"], time_conv3x3(sites, B)


def time_conv3x3(sites, B: int = 32, sweep: bool = False):
    """conv3x3 at every main-path shape at batch B, bf16, beside its bound, its plain version and
    F.conv2d + bias (device times from CUDA graphs; eager calls, host launch cost included,
    beside them), with the bf16 instantiation each shape takes; the sums are weighted by each
    shape's count per forward. With `sweep`, also every instantiation on every shape (each
    checked against the plain version at 2e-2 relative first)."""
    import torch.nn.functional as F

    from lpc_yolo_tpu_torch.ops.conv3x3 import CONFIGS, conv3x3, conv3x3_config, conv3x3_plain

    counts = {}
    for s in sites:
        counts[s] = counts.get(s, 0) + 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "eager_ms": 0.0, "library_eager_ms": 0.0}
    per_shape = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for (C, H, W, Co, act, pix, off), n in sorted(counts.items(), key=lambda kv: -kv[0][1]):
        xh = site_input((C, H, W, Co, act, pix, off), B, g, torch.bfloat16)
        xs = xh.permute(0, 3, 1, 2)  # the channels_last NCHW view F.conv2d takes
        w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).bfloat16()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        b = torch.rand(Co, device="cuda", generator=g) - 0.5
        b16 = b.bfloat16()
        k_ms = graph_ms(lambda: conv3x3(xh, w, b, act))
        p_ms = graph_ms(lambda: conv3x3_plain(xh, w, b, act))
        l_ms = graph_ms(lambda: F.conv2d(xs, w_oihw, b16, padding=1))
        k_eager = cuda_ms(lambda: conv3x3(xh, w, b, act))
        l_eager = cuda_ms(lambda: F.conv2d(xs, w_oihw, b16, padding=1))
        nbytes = (xh.numel() + w.numel() + B * H * W * Co) * 2 + Co * 4
        flops = 2 * B * H * W * 9 * C * Co
        bd, by = bound(nbytes, flops, BF16_FLOPS_PER_MS)
        cfg = conv3x3_config(B, H, W, C, Co)
        per_shape.append({"C": C, "H": H, "W": W, "Co": Co, "act": act, "pix": pix, "per_forward": n, "ms": k_ms,
                          "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bd, "bound_by": by,
                          "eager_ms": k_eager, "library_eager_ms": l_eager,
                          "bound_share": bd / k_ms, "vs_library": k_ms / l_ms, "tflops": flops / k_ms / 1e9,
                          "config": cfg.index, "tile": [cfg.tile_h, cfg.tile_w, cfg.bn, cfg.ck, cfg.stages],
                          "smem": cfg.smem, "blocks": cfg.grid[0] * cfg.grid[1]})
        log("times", f"conv3x3 b{B} {C}->{Co} @{H}x{W} {act} pix {pix} x{n}: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TF/s, "
                     f"{bd / k_ms:.3f} of bound, {k_ms / l_ms:.2f}x F.conv2d), plain {p_ms:.4f}, F.conv2d {l_ms:.4f}, "
                     f"bound {bd:.4f} ({by}); eager calls {k_eager:.4f}, F.conv2d {l_eager:.4f}; "
                     f"config {cfg.index} {per_shape[-1]['tile']}, {per_shape[-1]['blocks']} blocks")
        if sweep:
            ref = conv3x3_plain(xh.float(), w.float(), b, act)
            per_cfg = {}
            for i in range(len(CONFIGS)):
                err = ((conv3x3(xh, w, b, act, config=i).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
                assert err <= 2e-2, f"conv3x3 config {i} {CONFIGS[i]} on {C}->{Co} @{H}x{W}: relative err {err}"
                per_cfg[i] = graph_ms(lambda: conv3x3(xh, w, b, act, config=i))
            del ref
            per_shape[-1]["sweep_ms"] = per_cfg
            best = sorted(per_cfg, key=per_cfg.get)[:4]
            log("sweep", f"{C}->{Co} @{H}x{W}: chosen {cfg.index} {k_ms:.4f} ms; fastest "
                         + ", ".join(f"{i} {CONFIGS[i]} {per_cfg[i]:.4f}" for i in best))
        tot["ms"] += n * k_ms
        tot["eager_ms"] += n * k_eager
        tot["library_eager_ms"] += n * l_eager
        tot["plain_ms"] += n * p_ms
        tot["library_ms"] += n * l_ms
        tot["bound_ms"] += n * bd
        tot["bytes_ms"] += n * nbytes / HBM_BYTES_PER_MS
        tot["ops_ms"] += n * flops / BF16_FLOPS_PER_MS
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    log("times", f"conv3x3, all {len(sites)} sites of one b{B} forward: {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, "
                 f"F.conv2d {tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms; "
                 f"worst shape {max(r['vs_library'] for r in per_shape):.2f}x F.conv2d (device times, CUDA graph); "
                 f"eager calls {tot['eager_ms']:.3f} ms, F.conv2d {tot['library_eager_ms']:.3f}")
    REPORT["conv3x3_shapes"] = per_shape
    REPORT["conv3x3_sum"] = tot
    return tot


def time_repack(g):
    """The repack kernel beside its bytes bound, its plain version and a real copy of the same
    bytes (`x.clone()` on the contiguous feed, `.contiguous()` on the strided slices), at the
    training feed's shape (contiguous and as a strided slice) and on a strided (32, 320, 80, 192)
    bf16 slice: device times from CUDA graphs on a cold L2 (`cold_graph_ms`), the means of two
    readings each taken in the order kernel, copy, copy, kernel, eager calls beside;
    the plain version by eager calls only (on the contiguous feed it is a view: no device work)."""
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel, repack_width_plain

    feed = (TRAIN_BATCH, 640, 80, 24)
    out = {}
    for name, shape, dtype in (("contiguous", feed, torch.uint8), ("strided", feed, torch.uint8),
                               ("strided_bf16_act", (32, 320, 80, 192), torch.bfloat16)):
        pf, pt = (8, 1) if dtype == torch.uint8 else (4, 2)
        x = torch.randint(0, 256, shape, device="cuda", generator=g, dtype=torch.uint8) \
            if name == "contiguous" else strided_slice(shape, dtype, g)
        nbytes = 2 * x.numel() * x.element_size()
        xs = [x] + [x.clone() if name == "contiguous" else strided_slice(shape, dtype, g)
                    for _ in range(n_cold_sets(nbytes // 2) - 1)]
        sets = [(t,) for t in xs]
        yshape = repack_width_plain(x, pf, pt).shape
        copy = (lambda t: t.clone().view(yshape)) if name == "contiguous" else (lambda t: t.contiguous().view(yshape))
        # kernel, copy, copy, kernel: the two are compared only within these four readings
        readings = [cold_graph_ms(fn, sets, nbytes // 2) for fn in
                    (lambda t: repack_width_kernel(t, pf, pt), copy, copy, lambda t: repack_width_kernel(t, pf, pt))]
        r = out[name] = {
            "shape": list(shape), "dtype": str(dtype), "bytes": nbytes, "cold_sets": len(sets),
            "ms": (readings[0] + readings[3]) / 2, "library_ms": (readings[1] + readings[2]) / 2,
            "readings_kernel_copy_copy_kernel": readings,
            "plain_ms": cuda_ms(lambda: repack_width_plain(x, pf, pt)),  # eager: a view on the contiguous feed
            "library_call": "x.clone()" if name == "contiguous" else "x.contiguous()",
            "eager_ms": cuda_ms(lambda: repack_width_kernel(x, pf, pt)),
            "library_eager_ms": cuda_ms(lambda: copy(x)),
            "bound_ms": nbytes / HBM_BYTES_PER_MS}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        del xs, sets
        log("times", f"repack {name} {tuple(shape)} {dtype} {pf}->{pt}: {r['ms']:.4f} ms device time (CUDA graph, cold L2, "
                     f"{nbytes / r['ms'] / 1e9:.2f} TB/s, {r['bound_share']:.3f} of bound), {r['library_call']} "
                     f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f} (eager), bound {r['bound_ms']:.4f} ms (bytes); "
                     f"readings kernel/copy/copy/kernel {[round(v, 5) for v in readings]}; "
                     f"eager calls: kernel {r['eager_ms']:.4f}, {r['library_call']} {r['library_eager_ms']:.4f}")
    REPORT["repack_times"] = out
    return out


def train_batches(n: int, B: int, seed: int):
    """Loader-format host batches: uint8 BGR frames and a handful of padded boxes per image."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_gt = rng.integers(2, TRAIN_GT - 1, B)
        mask = np.arange(TRAIN_GT)[None, :] < n_gt[:, None]
        xy = rng.uniform(0, 400, (B, TRAIN_GT, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(24, 230, (B, TRAIN_GT, 2))], -1).astype(np.float32)
        out.append({"img": rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8),
                    "cls": rng.integers(0, 80, (B, TRAIN_GT)).astype(np.int32),
                    "bboxes": boxes * mask[..., None], "mask": mask})
    return out


def phase_train():
    import copy
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step, to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel

    yolo = YOLO(YAML, device="cuda", seed=0)
    before = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    batches = train_batches(TRAIN_STEPS, TRAIN_BATCH, seed=21)

    # the main path of this slice: the trainer takes a few steps, counters read around it
    letterbox.launches = conv3x3.launches = repack_width_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        yolo.train(batches=batches, epochs=1, save_dir=tmp)
    torch.cuda.synchronize()
    launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches, "repack": repack_width_kernel.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist, state = yolo.trainer.history, yolo.trainer.state
    for i, h in enumerate(hist):
        log("train", f"step {i}: loss {h['loss']:.4f} items {[round(v, 4) for v in h['items']]} lr {h['lr']:.2e} "
                     f"skipped {h['skipped']} ({h['seconds'] * 1e3:.1f} ms by host clock)")
        assert np.isfinite(h["loss"]) and np.isfinite(h["items"]).all() and len(h["items"]) == 6, h
        assert h["skipped"] is False, f"step {i} was skipped"
    assert len(hist) == TRAIN_STEPS and state.step == state.opt_step == state.ema_updates == TRAIN_STEPS
    assert launches == {"letterbox": 0, "conv3x3": 0, "repack": TRAIN_STEPS}, launches
    after = yolo.model.state_dict()
    moved = {kind: sum(not torch.equal(before[k], after[k]) for k in keys) / len(keys) for kind, keys in (
        ("params", list(state.params)), ("bn_stats", list(state.batch_stats)))}
    ema_off = sum(not torch.equal(state.ema_params[k], state.params[k]) for k in state.params) / len(state.params)
    # lr stays near 1e-4 in so short a run, so an update can round to nothing on a leaf of large values
    assert moved["params"] > 0.5 and moved["bn_stats"] == 1.0 and ema_off > 0.25, (moved, ema_off)
    assert all(torch.equal(after[k], v) for k, v in state.ema_params.items()), "the facade does not hold the EMA"
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    log("train", f"YOLO.train: {TRAIN_STEPS} steps, batch {TRAIN_BATCH}, 640, bf16 autocast; launches {launches}; "
                 f"moved: {moved}, EMA off the live params in {ema_off:.2f} of the leaves; peak memory {peak_gb:.3f} GB")

    # one f32 step on the card against the same step of the port on the CPU (batch 2)
    small = train_batches(1, 2, seed=22)[0]
    small["img"] = pack_img(small["img"])
    cfg = OptConfig(warmup_steps=100, total_steps=TRAIN_STEPS)
    items = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(yolo.model)
        st = init_train_state(model, cfg, device=dev)
        st, met = make_train_step(model, cfg, amp=False)(st, small)
        assert met["skipped"] is False
        items[dev] = np.concatenate([met["items"].cpu().numpy(), [float(met["loss"])]])
    rel = float(np.max(np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])))
    assert rel <= 1e-3, f"f32 step on the card vs on the CPU: loss items differ by {rel} (rtol 1e-3): {items}"
    log("train", f"one f32 step (batch 2) on the card vs on the CPU: loss items within {rel:.2e} (rtol 1e-3)")

    # times: the step alone from a device-resident packed batch (CUDA events), then its profile
    model = copy.deepcopy(yolo.model)
    cfg = OptConfig(warmup_steps=100, total_steps=1000)
    st = init_train_state(model, cfg, device="cuda")
    step = make_train_step(model, cfg)
    dev_batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda")) for b in batches[:2]]
    it = iter(range(10 ** 9))

    def one():
        step(st, dev_batches[next(it) % 2])

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one, iters=5, warmup=3)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = float(np.median([h["seconds"] for h in hist[2:]])) * 1e3
    log("train", f"train step b{TRAIN_BATCH} 640 bf16 from a device-resident packed batch (unpack + forward + loss + "
                 f"backward + SGD + EMA, one host sync): {step_ms:.3f} ms/step, {TRAIN_BATCH / step_ms * 1e3:.1f} img/s; "
                 f"peak memory {step_peak_gb:.3f} GB")
    log("train", f"Trainer loop from host numpy batches (pin + H2D + step + metrics fetch), median of steps 2..: "
                 f"{host_ms:.3f} ms/step, {TRAIN_BATCH / host_ms * 1e3:.1f} img/s")
    prof = profile_step(one)
    if prof["top"]:
        log("train", f"profile of the step: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
                     f"idle share {prof['idle_share']:.3f}; {prof['device_launches']:.0f} device launches a step; the host "
                     f"waits {prof['host_sync_wait_ms']:.3f} ms a step in the non-finite flag's .item()")
        for r in prof["top"]:
            log("train", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")
    else:
        log("train", "profiler recorded no device time: breakdown not measured")

    # the hand-back serves: predict on the trained facade goes through the letterbox and conv3x3 kernels
    letterbox.launches = conv3x3.launches = 0
    results = yolo.predict(frames_720p(4, seed=23), imgsz=640, batch=4, conf=0.0)
    torch.cuda.synchronize()
    served = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches}
    assert served == {"letterbox": 1, "conv3x3": CONV_SITES_PER_FORWARD}, served
    assert len(results) == 4 and all(np.isfinite(r.boxes.data).all() and len(r) > 0 for r in results)
    log("train", f"YOLO.predict on the trained facade: 4 frames -> {[len(r) for r in results]} boxes, launches {served}")
    REPORT["train"] = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "history": hist, "launches": launches,
                       "moved": moved, "peak_gb_trainer": peak_gb, "f32_card_vs_cpu_rel": rel, "step_ms": step_ms,
                       "img_s": TRAIN_BATCH / step_ms * 1e3, "peak_gb_step": step_peak_gb, "host_step_ms": host_ms,
                       "profile": prof, "served_launches": served}


def write_val_dataset(root: Path, n: int, seed: int):
    """`n` seeded frames cycling through VAL_SHAPES under root/images/val, each as a PNG and its
    .npy twin (what `cache_images="disk"` reads); returns the image paths and the frames."""
    from lpc_yolo_tpu_torch.data.synthetic import write_png

    img_dir = root / "images" / "val"
    img_dir.mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    files, frames = [], []
    for i in range(n):
        im = rng.integers(0, 256, VAL_SHAPES[i % len(VAL_SHAPES)] + (3,), dtype=np.uint8)
        f = img_dir / f"{i:03d}.png"
        write_png(f, im)
        np.save(f.with_suffix(".npy"), im)
        files.append(f)
        frames.append(im)
    return files, frames


def write_val_labels(files, frames, dets, imgsz: int) -> int:
    """YOLO label files from detections in letterbox pixels (the validator's scaleup=False geometry):
    per frame the strongest up to 3 mutually non-overlapping boxes, kept as they are (the random
    weights' boxes may reach past the frame); every VAL_UNLABELLED-th frame gets no label file.
    Returns the number of boxes written."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_geometry
    from lpc_yolo_tpu_torch.utils.metrics import box_iou_np

    n_boxes = 0
    for i, (f, im, det) in enumerate(zip(files, frames, dets)):
        if i % VAL_UNLABELLED == VAL_UNLABELLED - 1:
            continue
        h0, w0 = im.shape[:2]
        gain, _, (pw, ph) = letterbox_geometry((h0, w0), (imgsz, imgsz), scaleup=False)
        keep = []
        for row in det:  # strongest first
            b = row[:4].astype(np.float64)
            if min(b[2] - b[0], b[3] - b[1]) < 8:
                continue
            if keep and box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, int(row[5])))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = (b - [pw, ph, pw, ph]) / gain
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        n_boxes += len(lines)
        (f.parents[2] / "labels" / "val" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    return n_boxes


def val_launches_expected(frames, batch: int):
    """Launches one val run makes: a letterbox per (batch, frame shape) and 28 conv3x3 per batch."""
    n_batches = -(-len(frames) // batch)
    groups = sum(len({im.shape for im in frames[i:i + batch]}) for i in range(0, len(frames), batch))
    return {"letterbox": groups, "conv3x3": CONV_SITES_PER_FORWARD * n_batches}


def phase_parity_letterbox_val():
    """The letterbox kernel on the validator's scaleup=False tables against its plain version, u8,
    bit-exact: a frame smaller than 640 (padded only: its content must equal the RGB frame) and
    the two larger shapes."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    rng = np.random.default_rng(4)
    for h0, w0 in VAL_SHAPES:
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        tab = tables_on(h0, w0, 640, frames.device, False)
        got = letterbox(frames, 640, out_dtype=torch.uint8, scaleup=False)
        ref = letterbox_plain(frames, tab, 640, torch.uint8)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"letterbox scaleup=False {h0}x{w0}: kernel != plain (u8)"
        if h0 <= 640 and w0 <= 640:
            top, left = (int((tab[k] >= 0).int().argmax()) for k in (0, 4))  # first content row / column
            assert torch.equal(got[:, top:top + h0, left:left + w0], frames.flip(-1)), "scaleup=False resized a small frame"
    log("val", f"letterbox kernel vs plain on scaleup=False tables {list(VAL_SHAPES)} -> 640: bit-exact (u8); "
               f"the {VAL_SHAPES[-1]} frame is copied unscaled")


def val_batch_device_ms(validator, model, frames):
    """One validation batch's device work from device-resident frames (letterbox per shape group,
    cast, forward with /255 folded into the stem, decode): event-timed ms, and the profiler's device busy ms
    and idle share."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    S, B = validator.imgsz, len(frames)
    groups = {}
    for j, im in enumerate(frames):
        groups.setdefault(im.shape, []).append(j)
    srcs = [(slots, torch.from_numpy(np.stack([frames[j] for j in slots])).cuda()) for slots in groups.values()]
    x = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")

    def step():
        for slots, src in srcs:
            letterbox(src, S, out=x, slots=slots, scaleup=False)
        return model.predict(x.permute(0, 3, 1, 2).to(validator.dtype), validator.max_det)

    with torch.inference_mode():
        ms = cuda_ms(step, iters=5, warmup=2)
        prof = profile_step(step)
    return ms, prof


def val_host_parts(yolo, data: Path, batch: int) -> dict:
    """Host seconds of the parts of a val run that its `speed` dict leaves out: the dataset (YAML,
    scan, label cache), the BN-folded serving copy, and one pass of the loader (the .npy twins read
    and transformed by the worker threads), each timed alone."""
    from lpc_yolo_tpu_torch.data import DataLoader, ValTransforms, YOLODataset, check_det_dataset
    from lpc_yolo_tpu_torch.engine.predictor import serving_model

    t0 = time.perf_counter()
    info = check_det_dataset(str(data))
    ds = YOLODataset(info["val"], cache_images="disk")
    t1 = time.perf_counter()
    serving_model(yolo.model, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = sum(len(b["img"]) - b["pad_count"] for b in DataLoader(ds, ValTransforms(640), batch_size=batch))
    t3 = time.perf_counter()
    assert n == len(ds)
    return {"dataset_s": t1 - t0, "serving_copy_s": t2 - t1, "loader_s": t3 - t2}


def phase_val():
    """YOLO.val(data=...) on a dataset written to a temp dir (VAL_FRAMES frames of VAL_SHAPES as
    PNGs with .npy twins; labels from the port's own f32 detections on the card through the same
    scaleup=False geometry), at 640, batch 32, from the files on disk: f32 and bf16 with the launch
    counters reset just before and read just after each run; f32 on the card against the CPU on a
    VAL_SUBSET-frame subset; bf16 finite and its mAP50 near f32's; times."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.engine.validator import Validator
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    phase_parity_letterbox_val()
    S, B = 640, VAL_BATCH
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_val_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        files, frames = write_val_dataset(root, VAL_FRAMES, seed=31)
        yolo = YOLO(YAML, device="cuda", seed=0)
        v32 = Validator(yolo, imgsz=S, device="cuda", dtype=torch.float32)
        m32 = serving_model(yolo.model, v32.device, torch.float32)
        dets = np.concatenate([v32.predict(m32, v32.preprocess(frames[i:i + B])) for i in range(0, len(frames), B)])
        n_boxes = write_val_labels(files, frames, dets, S)
        data = root / "data.yaml"
        data.write_text(json.dumps({"path": str(root), "val": "images/val", "nc": 80}))  # JSON is YAML
        subset = [files[i] for i in range(VAL_SUBSET)]
        (root / "subset.txt").write_text("".join(f"{f}\n" for f in subset))
        (root / "subset.yaml").write_text(json.dumps({"path": str(root), "val": "subset.txt", "nc": 80}))
        log("val", f"dataset: {len(files)} frames {dict((str(sh), sum(im.shape[:2] == sh for im in frames)) for sh in VAL_SHAPES)} "
                   f"as PNG + .npy, {n_boxes} labelled boxes, written in {time.perf_counter() - t0:.1f} s")
        expect = val_launches_expected(frames, B)

        runs = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("bf16_again", torch.bfloat16)):
            letterbox.launches = conv3x3.launches = 0
            t0 = time.perf_counter()
            res = yolo.val(data=str(data), imgsz=S, batch=B, cache_images="disk", dtype=dt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches}
            assert launches == expect, f"val {name}: launches {launches}, expected {expect}"
            speed = dict(yolo.validator.speed)
            speed["loader_and_rest"] = wall - sum(speed.values())
            runs[name] = {"results": res, "wall_s": wall, "img_s": len(files) / wall, "launches": launches,
                          "speed_ms_per_image": {k: v * 1e3 / len(files) for k, v in speed.items()}}
            log("val", f"YOLO.val {name}: {len(files)} images, batch {B}, {wall:.3f} s = {len(files) / wall:.1f} img/s "
                       f"from the files on disk; per image (ms) "
                       f"{ {k: round(v, 3) for k, v in runs[name]['speed_ms_per_image'].items()} }; launches {launches}")
            log("val", f"  {res}")
        host = val_host_parts(yolo, data, B)
        log("val", f"host parts outside `speed`, each alone (s): {host}; per image (ms): "
                   f"{ {k: round(v * 1e3 / len(files), 3) for k, v in host.items()} }")
        f32, bf16 = runs["f32"]["results"], runs["bf16"]["results"]
        assert f32["metrics/mAP50(B)"] > 0.3, f"f32 mAP50 {f32['metrics/mAP50(B)']}: the labels are its own detections"
        assert all(np.isfinite(v) for v in bf16.values()), f"bf16 results not finite: {bf16}"
        gap = abs(bf16["metrics/mAP50(B)"] - f32["metrics/mAP50(B)"])
        assert gap <= VAL_BF16_MAP50_TOL, f"bf16 mAP50 {bf16['metrics/mAP50(B)']} vs f32 {f32['metrics/mAP50(B)']}"
        log("val", f"bf16 finite; mAP50 bf16 {bf16['metrics/mAP50(B)']:.4f} vs f32 {f32['metrics/mAP50(B)']:.4f} "
                   f"(gap {gap:.4f}, tol {VAL_BF16_MAP50_TOL})")

        # f32 on the card (kernels) against the CPU (plain versions) on the subset
        card = yolo.val(data=str(root / "subset.yaml"), imgsz=S, batch=4, cache_images="disk", dtype=torch.float32)
        cpu_yolo = YOLO(YAML, device="cpu", seed=0)
        cpu = cpu_yolo.val(data=str(root / "subset.yaml"), imgsz=S, batch=4, cache_images="disk")
        worst = max(abs(card[k] - cpu[k]) for k in cpu)
        assert card.keys() == cpu.keys() and worst <= VAL_F32_TOL, f"val f32 card {card} vs CPU {cpu}"
        log("val", f"f32 on the card vs the CPU, {VAL_SUBSET} frames: every key within {worst:.3g} "
                   f"(tol {VAL_F32_TOL}); card {card}")

        # one b32 batch's device work, bf16 (the validator's default on the card)
        v16 = Validator(yolo, imgsz=S, device="cuda")
        dev_ms, prof = val_batch_device_ms(v16, serving_model(yolo.model, v16.device, v16.dtype), frames[:B])
        log("val", f"one b{B} val batch on the device (letterbox x{len({im.shape for im in frames[:B]})}, cast, forward, "
                   f"decode), bf16: {dev_ms:.3f} ms event-timed; profiler busy {prof['device_busy_ms']:.3f} ms, "
                   f"idle share {prof['idle_share']:.3f}, {prof['device_launches']:.0f} launches")
        out = {"frames": len(files), "shapes": [list(sh) for sh in VAL_SHAPES], "labelled_boxes": n_boxes,
               "runs": runs, "host_parts_s": host, "card_vs_cpu": {"card": card, "cpu": cpu, "max_abs_diff": worst},
               "bf16_map50_gap": gap, "batch_device_ms": dev_ms, "batch_profile": prof}
    REPORT["val"] = out


def loader_batches(loader, n: int):
    """The first n batches of a loader, and the host ms each took (file reads and plans, worker threads)."""
    it, out, ms = iter(loader), [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(next(it))
        ms.append((time.perf_counter() - t0) * 1e3)
    it.close()
    return out, ms


def write_train_dataset(root: Path) -> str:
    """The synthetic nc=3 dataset of phases 8 and 9 under root; returns its YAML."""
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    data = make_synthetic_dataset(root, n_train=TD_TRAIN, n_val=TD_VAL, nc=3, max_boxes=6, seed=41, shapes=VAL_SHAPES)
    log("train_data", f"dataset: {TD_TRAIN} train + {TD_VAL} val frames of {list(VAL_SHAPES)} as PNG + .npy, "
                      f"written in {time.perf_counter() - t0:.1f} s")
    return data


def phase_train_data(data: str):
    """YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=...) from a synthetic dataset written to a temp dir
    (`write_train_dataset`: TD_TRAIN frames of VAL_SHAPES, 1 to 6 rectangles each, PNG + .npy twins read
    through cache="disk"; TD_VAL validation frames): TD_EPOCHS epochs at 640, batch 16, optimizer "auto" (AdamW), the last
    epoch letterboxed (close_mosaic=1), with the launch counters reset just before and read just after.
    Then the loader and the card's render against the CPU, the render's device time and launches, and
    AdamW on the card against the CPU."""
    import copy
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import DataLoader, TrainTransforms, YOLODataset, check_det_dataset, render
    from lpc_yolo_tpu_torch.engine.train_step import (OptConfig, apply_update, global_norm, init_train_state,
                                                      make_train_step)
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel

    S, B, dev = 640, TD_BATCH, torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_run_") as tmp:
        info = check_det_dataset(data)
        steps = -(-TD_TRAIN // B) * TD_EPOCHS
        val_frames = [np.load(f) for f in sorted(Path(info["val"]).glob("*.npy"))]
        expect_val = {k: v * TD_EPOCHS for k, v in val_launches_expected(val_frames, min(B, 8)).items()}

        # this slice's main path: the trainer from the dataset, counters read around it
        yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
        letterbox.launches = conv3x3.launches = repack_width_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = yolo.train(data=data, imgsz=S, batch=B, epochs=TD_EPOCHS, close_mosaic=1, optimizer="auto",
                         workers=8, cache="disk", save_dir=Path(tmp) / "run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches,
                    "repack": repack_width_kernel.launches}
        tr = yolo.trainer
        hist, rows = tr.history, tr.epoch_history
        for h in hist:
            assert np.isfinite(h["loss"]) and np.isfinite(h["items"]).all() and h["skipped"] is False, h
        assert len(hist) == steps and tr.state.opt_step == steps, (len(hist), tr.state.opt_step)
        assert tr.cfg.optimizer == "adamw" and tr.cfg.lr0 == 0.002 and tr.cfg.momentum == 0.9, tr.cfg
        assert launches == {**expect_val, "repack": steps}, (launches, expect_val, steps)
        assert set(res) >= {"metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"}
        assert all(np.isfinite(list(res.values()))), res
        step_s = sum(h["seconds"] for h in hist)
        ckpt_s = sum(w["encode_s"] + w["write_s"] for w in tr.ckpt_seconds)  # save=True by default: one a epoch
        for r in rows:
            log("train_data", f"epoch {r['epoch']}: {r['seconds']:.3f} s, input_wait_frac {r['input_wait_frac']:.4f}, "
                              f"render_frac {r['render_frac']:.4f}, "
                              f"box_om {r['box_om']:.4f} cls_om {r['cls_om']:.4f}, mAP50 {r['metrics/mAP50(B)']:.4f}")
        log("train_data", f"YOLO(nc=3).train(data=...): {steps} steps of b{B} at {S}, AdamW by the auto rule, "
                          f"3 validations; {wall:.3f} s = {TD_TRAIN * TD_EPOCHS / wall:.1f} img/s over the call, "
                          f"{steps * B / step_s:.1f} img/s over the steps (loader wait + render + step), "
                          f"{ckpt_s:.3f} s of it in {len(tr.ckpt_seconds)} checkpoint saves; peak "
                          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {launches} "
                          f"(expected {expect_val}, repack {steps})")

        # the loader and the render: the trainer's loader (plans) on the card against the JAX-order CPU path
        ds = YOLODataset(info["train"], cache_images="disk")
        tt = TrainTransforms(S)
        plans_a, loader_ms = loader_batches(DataLoader(ds, tt.plan, B, workers=8, shuffle=True, infinite=True), 3)
        plans_b, _ = loader_batches(DataLoader(ds, tt.plan, B, workers=1, shuffle=True, infinite=True), 2)
        worst = 0
        for a, b in zip(plans_a, plans_b):
            assert [[t.src for t in p.canvas.tiles if t] for p in a["plan"]] == \
                [[t.src for t in p.canvas.tiles if t] for p in b["plan"]], "loaders disagree on the source frames"
            for k in ("cls", "bboxes", "mask"):
                assert np.array_equal(a[k], b[k]), f"loaders disagree on {k}"
            card = render(a["plan"], a["sources"], dev).cpu()
            cpu = render(b["plan"], b["sources"], torch.device("cpu"))
            worst = max(worst, int((card.int() - cpu.int()).abs().max()))
        assert worst <= 1, f"card render vs CPU render: {worst} LSB"
        batch = plans_a[2]
        src_bytes = sum(v.nbytes for v in batch["sources"].values())
        out_bytes = B * S * S * 3
        render_ms = cuda_ms(lambda: render(batch["plan"], batch["sources"], dev), iters=3, warmup=1)
        prof = profile_step(lambda: render(batch["plan"], batch["sources"], dev))
        log("train_data", f"loaders (8 and 1 workers, seed 0): first two batches equal in source frames and labels; "
                          f"card render = CPU render within {worst} LSB (tol 1)")
        log("train_data", f"render of a b{B} mosaic batch: {render_ms:.3f} ms event-timed from host plans; device busy "
                          f"{prof['device_busy_ms']:.3f} ms over {prof['device_launches']:.0f} launches "
                          f"(idle share {prof['idle_share']}); loader host ms per batch "
                          f"{[round(v, 1) for v in loader_ms]}; "
                          f"H2D {src_bytes / 1e6:.1f} MB of {len(batch['sources'])} source frames against "
                          f"{out_bytes / 1e6:.1f} MB rendered")
        for r in prof["top"][:8]:
            log("train_data", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")

        # AdamW on the card against the CPU, f32: one train step on a rendered batch (batch 2; it updates with
        # lr 0, the warmup's start), its loss items; then three updates from a fresh state on the same seeded
        # gradients, large (the clip acts) to small: parameters, both moments and the EMA
        small = {k: v[:2] for k, v in plans_a[0].items() if k in ("cls", "bboxes", "mask")}
        small["img"] = pack_img(render(plans_a[0]["plan"][:2], plans_a[0]["sources"], torch.device("cpu")).numpy())
        cfg = OptConfig(lr0=0.002, momentum=0.9, warmup_steps=2, total_steps=steps, optimizer="adamw")
        items, states = {}, {}
        for d in ("cuda", "cpu"):
            model = copy.deepcopy(yolo.model)
            st = init_train_state(model, cfg, device=d)
            st, met = make_train_step(model, cfg, amp=False)(st, small)
            assert met["skipped"] is False
            items[d] = np.concatenate([met["items"].cpu().numpy(), [float(met["loss"])]])
            st = init_train_state(copy.deepcopy(yolo.model), cfg, device=d)
            g = np.random.default_rng(7)
            for scale in (3.0, 1.0, 1e-3):
                grads = [torch.from_numpy((scale * g.standard_normal(tuple(p.shape))).astype(np.float32)).to(d)
                         for p in st.params.values()]
                apply_update(st, grads, global_norm(grads), cfg)
            states[d] = st
        rel = float(np.max(np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])))
        assert rel <= 1e-3, f"f32 AdamW step on the card vs on the CPU: loss items differ by {rel}: {items}"
        upd = 0.0
        for name in ("params", "momentum", "nu", "ema_params"):
            card, cpu = getattr(states["cuda"], name), getattr(states["cpu"], name)
            for k, ref in cpu.items():
                ref = ref.detach()
                upd = max(upd, float((card[k].detach().cpu() - ref).abs().max() / ref.abs().max().clamp(min=1e-30)))
        assert upd <= 2e-6, f"AdamW updates on the card vs the CPU: {upd} of a leaf's largest value"
        log("train_data", f"one f32 AdamW step (batch 2) on the card vs on the CPU: loss items within {rel:.2e} "
                          f"(rtol 1e-3); three AdamW updates on the same gradients: parameters, moments and EMA "
                          f"within {upd:.2e} of each leaf's largest value (tol 2e-6)")
        REPORT["train_data"] = {
            "steps": steps, "batch": B, "epochs": TD_EPOCHS, "wall_s": wall, "img_s_call": TD_TRAIN * TD_EPOCHS / wall,
            "img_s_steps": steps * B / step_s, "ckpt_s": ckpt_s, "epochs_rows": rows, "history": hist, "launches": launches,
            "results": res, "render_card_vs_cpu_lsb": worst, "render_ms": render_ms, "render_profile": prof,
            "loader_host_ms": loader_ms, "h2d_source_mb": src_bytes / 1e6, "rendered_mb": out_bytes / 1e6,
            "adamw_card_vs_cpu_rel": rel, "adamw_update_card_vs_cpu": upd,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return launches


def state_trees(state):
    """A TrainState's tensors by tree name, and its counters."""
    trees = {f: getattr(state, f) for f in ("params", "batch_stats", "momentum", "nu", "ema_params")}
    return trees, (state.step, state.opt_step, state.ema_updates)


def phase_checkpoint(data: str):
    """This slice's main path: YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=..., save=True) on phase 8's
    dataset into a temp dir, with the launch counters reset just before and read just after; its
    weights/last.ckpt, best.ckpt and a results.csv of TD_EPOCHS rows; last.ckpt read back into a card
    TrainState equal to the trainer's final state bit for bit; a run stopped by SIGTERM in the first step
    of epoch 2 and resumed with resume=True runs epochs 2 and 3, once each, from the saved counters;
    YOLO.save -> YOLO(path, device="cuda") -> predict gives the saved model's detections."""
    import signal
    import tempfile

    import lpc_yolo_tpu_torch.engine.trainer as trainer_mod
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import check_det_dataset
    from lpc_yolo_tpu_torch.nn import build_model
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint, read_meta
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
    from lpc_yolo_tpu_torch.utils.flax_bridge import train_state_from_dict

    S, B = 640, TD_BATCH
    spe = -(-TD_TRAIN // B)
    kw = dict(data=data, imgsz=S, batch=B, epochs=TD_EPOCHS, close_mosaic=1, optimizer="auto", workers=8,
              cache="disk", save=True)
    val_frames = [np.load(f) for f in sorted(Path(check_det_dataset(data)["val"]).glob("*.npy"))]
    expect = {k: v * TD_EPOCHS for k, v in val_launches_expected(val_frames, min(B, 8)).items()}
    expect["repack"] = spe * TD_EPOCHS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        root = Path(tmp)
        yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
        letterbox.launches = conv3x3.launches = repack_width_kernel.launches = 0
        t0 = time.perf_counter()
        yolo.train(save_dir=root / "full", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches,
                    "repack": repack_width_kernel.launches}
        tr = yolo.trainer
        assert launches == expect, (launches, expect)
        assert all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
        weights = root / "full" / "weights"
        assert sorted(p.name for p in weights.iterdir()) == ["best.ckpt", "last.ckpt"], list(weights.iterdir())
        rows = (root / "full" / "results.csv").read_text().splitlines()
        assert len(rows) == 1 + TD_EPOCHS and rows[0].startswith("epoch,train/box_om,") \
            and rows[0].endswith(",lr,time_s,input_wait_frac,render_frac"), rows[0]
        last = weights / "last.ckpt"
        assert read_meta(last) == {"epoch": TD_EPOCHS - 1, "fitness": tr.epoch_history[-1]["fitness"]}
        size = last.stat().st_size
        writes = tr.ckpt_seconds
        log("ckpt", f"YOLO(nc=3).train(data=..., save=True): {spe * TD_EPOCHS} steps, {TD_EPOCHS} validations, "
                    f"{wall:.3f} s; launches {launches}; files {sorted(p.name for p in weights.iterdir())} + "
                    f"results.csv ({len(rows) - 1} rows)")

        # last.ckpt back into a card TrainState: every tensor and counter equal to the trainer's, bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, meta = load_checkpoint(last)
        t1 = time.perf_counter()
        model = build_model(yolo.model_yaml, device="cuda", nc=3)
        st = train_state_from_dict(model, tr.cfg, tree, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        (got, got_n), (ref, ref_n) = state_trees(st), state_trees(tr.state)
        assert got_n == ref_n == (spe * TD_EPOCHS,) * 3, (got_n, ref_n)
        n_leaves = 0
        for name in ref:
            assert got[name].keys() == ref[name].keys(), name
            for k, v in ref[name].items():
                assert torch.equal(got[name][k], v.detach()), f"{name} {k} differs after the round trip"
                n_leaves += 1
        read = {"file_s": t1 - t0, "to_card_s": t2 - t1}
        log("ckpt", f"last.ckpt -> card TrainState: {n_leaves} tensors and 3 counters equal bit for bit; "
                    f"file {size / 1e6:.3f} MB; write per epoch (host copy + encode, then the files) "
                    f"{[round(w['encode_s'], 4) for w in writes]} s + {[round(w['write_s'], 4) for w in writes]} s; "
                    f"read {read['file_s']:.4f} s + {read['to_card_s']:.4f} s into the card state")

        # stopped in the first step of epoch 2 (SIGTERM: the step finishes, last.ckpt stays epoch 1's), resumed
        real_render, calls = trainer_mod.render, []

        def stopping_render(plans, sources, device):
            calls.append(1)
            if len(calls) == spe + 1:
                signal.raise_signal(signal.SIGTERM)
            return real_render(plans, sources, device)

        trainer_mod.render = stopping_render
        try:
            stopped = YOLO(YAML, device="cuda", seed=0, nc=3)
            stopped.train(save_dir=root / "stopped", **kw)
        finally:
            trainer_mod.render = real_render
        assert stopped.trainer.preempted and len(stopped.trainer.history) == spe + 1
        assert read_meta(root / "stopped" / "weights" / "last.ckpt")["epoch"] == 0
        resumed = YOLO(YAML, device="cuda", seed=0, nc=3)
        resumed.train(save_dir=root / "stopped", resume=True, **kw)
        rt = resumed.trainer
        epochs_run = [h["epoch"] for h in rt.history]
        assert rt.start_epoch == 1 and epochs_run == [1] * spe + [2] * spe, epochs_run
        assert state_trees(rt.state)[1] == (spe * TD_EPOCHS,) * 3
        assert len((root / "stopped" / "results.csv").read_text().splitlines()) == 1 + TD_EPOCHS
        # every tensor of the resumed state against the uninterrupted run's: the card's kernels are not all
        # bit-reproducible, so held within RESUME_TOL of each leaf's largest value
        (res_trees, _), (ref_trees, _) = state_trees(rt.state), state_trees(tr.state)
        drift = {name: max(float((res_trees[name][k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                           for k, v in tree.items()) for name, tree in ref_trees.items()}
        assert max(drift.values()) <= RESUME_TOL, f"resumed run vs uninterrupted run: {drift} (tol {RESUME_TOL})"
        log("ckpt", f"stopped by SIGTERM in epoch 2 step 1 (epoch 1's last.ckpt kept), resumed: epochs "
                    f"{sorted({e + 1 for e in epochs_run})} ran once each from step {spe}, ending at step "
                    f"{rt.state.step}; against the uninterrupted run, the largest difference over each leaf's "
                    f"largest value: {drift} (tol {RESUME_TOL})")

        # YOLO.save -> YOLO(path) on the card -> predict: the saved model's detections
        path = yolo.save(root / "model.ckpt")
        back = YOLO(path, device="cuda")
        assert back.names == yolo.names and back.model.nc == 3
        a, b = yolo.model.state_dict(), back.model.state_dict()
        assert all(torch.equal(a[k], b[k].to(a[k].device)) for k in a)
        frames = frames_720p(4, seed=51)
        r1 = yolo.predict(frames, imgsz=S, batch=4, conf=0.0)
        r2 = back.predict(frames, imgsz=S, batch=4, conf=0.0)
        same = all(np.array_equal(x.boxes.data, y.boxes.data) for x, y in zip(r1, r2))
        for x, y in zip(r1, r2):
            assert len(x) > 0
            assert_detections_close(y.boxes.data, x.boxes.data, atol_box=1e-3, atol_score=1e-4)
        log("ckpt", f"YOLO.save -> YOLO(path, device='cuda') -> predict: weights equal, detections "
                    f"{'identical' if same else 'equal within box 1e-3 / score 1e-4'} ({[len(r) for r in r2]} boxes)")
        REPORT["checkpoint"] = {"launches": launches, "wall_s": wall, "ckpt_bytes": size, "writes": writes,
                                "read_s": read, "tensors": n_leaves, "resume_epochs": epochs_run,
                                "resume_drift": drift, "predict_identical": same}
    return launches


def converge_only() -> int:
    """`--converge`: the learning proof of tools/train_convergence.py on the card: LPC-YOLO (nc=3, seed 0)
    trained on the synthetic set of 256 + 32 frames at 160 for CONV_EPOCHS epochs of b16 (close_mosaic
    40, max_gt 8, cache="ram", val=False, patience CONV_EPOCHS, save=True), then validated at f32 and
    at bf16 on the trained weights reloaded through YOLO.save -> YOLO(path). Fails under mAP50 0.5."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict

    S = 160
    with tempfile.TemporaryDirectory(prefix="chip_smoke_converge_") as tmp:
        root = Path(tmp)
        t_start = time.perf_counter()
        data = make_synthetic_dataset(root / "ds", n_train=256, n_val=32, imgsz=S, nc=3, max_boxes=4, seed=3)
        yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
        t0 = time.perf_counter()
        yolo.train(data=data, epochs=CONV_EPOCHS, batch=16, imgsz=S, workers=8, max_gt=8, cache="ram",
                   close_mosaic=40, val=False, patience=CONV_EPOCHS, save=True, save_dir=root / "run")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        tr = yolo.trainer
        n_skipped = sum(h["skipped"] for h in tr.history)
        for r in tr.epoch_history[::10] + tr.epoch_history[-1:]:
            log("converge", f"epoch {r['epoch']}: box_om {r['box_om']:.4f} cls_om {r['cls_om']:.4f} "
                            f"dfl_om {r['dfl_om']:.4f} lr {r['lr']:.3g} {r['seconds']:.2f} s")
        # the trained weights: last.ckpt's EMA and BN statistics are what the facade holds
        tree, meta = load_checkpoint(root / "run" / "weights" / "last.ckpt")
        held = yolo.model.state_dict()
        for k, v in flax_to_state_dict({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]}).items():
            assert torch.equal(held[k].cpu(), v), f"last.ckpt {k} != the trained facade"
        trained = YOLO(yolo.save(root / "trained.ckpt"), device="cuda")
        res = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            res[name] = trained.val(data=data, imgsz=S, batch=16, dtype=dt, cache_images="ram")
            log("converge", f"val {name}: {res[name]}")
        wall = time.perf_counter() - t_start
    m50, m5095 = res["f32"]["metrics/mAP50(B)"], res["f32"]["metrics/mAP50-95(B)"]
    gap = {k: res["bf16"][k] - res["f32"][k] for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)")}
    out = {"mAP50": m50, "mAP50_95": m5095, "bf16_minus_f32": gap, "epochs": CONV_EPOCHS, "steps": len(tr.history),
           "skipped": n_skipped, "optimizer": tr.cfg.optimizer, "train_s": train_s, "wall_s": wall,
           "img_s": 256 * CONV_EPOCHS / train_s, "f32": res["f32"], "bf16": res["bf16"],
           "ckpt_bytes": tr.ckpt_seconds[-1]["bytes"], "epochs_rows": tr.epoch_history}
    REPORT["converge"] = out
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "chip_smoke_converge.json").write_text(json.dumps(REPORT, indent=1))
    log("converge", f"mAP50 {m50:.4f}, mAP50-95 {m5095:.4f} (f32); bf16 - f32: mAP50 {gap['metrics/mAP50(B)']:+.4f}, "
                    f"mAP50-95 {gap['metrics/mAP50-95(B)']:+.4f}; {len(tr.history)} steps ({n_skipped} skipped, "
                    f"{tr.cfg.optimizer}) in {train_s:.1f} s, {wall:.1f} s in all")
    if not m50 > CONV_MAP50_BAR:
        log("converge", f"FAILED: mAP50 {m50:.4f} <= {CONV_MAP50_BAR}")
        return 1
    return 0


def conv3x3_only() -> None:
    """`--conv3x3`: the conv3x3 kernel alone: its sites from one bf16 frame, its parity phase
    and its per-shape times at b32 with every instantiation swept; no other kernel, no serving
    profile, no training."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    yolo = YOLO(YAML, device="cuda", seed=0)
    sites = conv_sites(Predictor(yolo.model, imgsz=640, batch=1, device="cuda", dtype=torch.bfloat16))
    conv_err = phase_parity_conv(sites)
    time_conv3x3(sites, 32, sweep=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_conv3x3.json").write_text(json.dumps(REPORT, indent=1))
    log("done", f"conv3x3 alone: parity passed (f32 max abs {conv_err:.3g}), times in chiprun_out/chip_smoke_conv3x3.json")


def main(argv) -> int:
    if argv not in ([], ["--conv3x3"], ["--converge"]):
        print(f"chip_smoke: unknown arguments {argv}; the options are --conv3x3 and --converge", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "lpc_yolo_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the lpc_yolo_tpu_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    if argv == ["--conv3x3"]:
        conv3x3_only()
        return 0
    if argv == ["--converge"]:
        rc = converge_only()
        print(smi)
        print(json.dumps({"ok": rc == 0, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return rc
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    lb_err = phase_parity_letterbox()
    rp_err = phase_parity_repack()
    yolo = YOLO(YAML, device="cuda", seed=0)
    assert sum(p.numel() for p in yolo.model.parameters()) == 3_968_338
    pred16 = Predictor(yolo.model, imgsz=640, batch=4, device="cuda", dtype=torch.bfloat16)
    sites = conv_sites(pred16)
    conv_err = phase_parity_conv(sites)
    REPORT["predict_launches"] = phase_slice(yolo, pred16)
    lb, conv = phase_times(yolo, sites)
    del yolo, pred16
    torch.cuda.empty_cache()
    rp = time_repack(torch.Generator(device="cuda").manual_seed(3))["contiguous"]
    phase_train()
    torch.cuda.empty_cache()
    phase_val()
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_data_") as tmp:
        data = write_train_dataset(Path(tmp))
        phase_train_data(data)  # YOLO(nc=3).train(data=...), its counters held in the phase
        torch.cuda.empty_cache()
        launches = phase_checkpoint(data)  # the main path: YOLO(nc=3).train(data=..., save=True)
    kernels = [
        {"name": "letterbox", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/letterbox.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_preprocess.py:103", "launches": launches["letterbox"],
         "max_abs_err": lb_err, "ms": lb["ms"], "plain_ms": lb["plain_ms"], "bound_ms": lb["bound_ms"],
         "bound_by": lb["bound_by"], "library_ms": None},
        {"name": "conv3x3", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/conv3x3.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_conv.py:44", "launches": launches["conv3x3"],
         "max_abs_err": conv_err, "ms": conv["ms"], "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
         "bound_by": conv["bound_by"], "library_ms": conv["library_ms"]},
        {"name": "repack", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/repack.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_layout.py:35", "launches": launches["repack"],
         "max_abs_err": rp_err, "ms": rp["ms"], "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
         "bound_by": "bytes", "library_ms": rp["library_ms"]},
    ]
    REPORT["kernels"] = kernels
    REPORT["total_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    log("done", f"all phases passed in {REPORT['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
