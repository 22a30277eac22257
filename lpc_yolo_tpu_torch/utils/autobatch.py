"""The batch size that fits the card (counterpart of `lpc_yolo_tpu/utils/autobatch.py`; reference
utils/autobatch.py:13-70).

The rule is the JAX package's: the largest power-of-two batch, up to `max_batch`, whose training
step fits `fraction` (60%) of the device's memory. The JAX package reads each candidate's peak from
XLA's ahead-of-time memory analysis; here each candidate runs one real step on the card and its peak
is read from the caching allocator (`torch.cuda.reset_peak_memory_stats` / `max_memory_allocated`),
against the card's total memory (`torch.cuda.mem_get_info()[1]`). An out-of-memory error in a probe
ends the search there, as in the reference's CUDA autobatch; nothing else catches one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch


def device_memory_bytes(device=None) -> int:
    """The card's total memory in bytes."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"autobatch reads the card's memory; give a batch size on {device}")
    return int(torch.cuda.mem_get_info(device)[1])


def step_memory_bytes(fn: Callable, *args) -> int:
    """The peak bytes allocated on the card while `fn(*args)` runs (one probe step), or -1 when it runs out of
    memory. The probe's tensors are freed, and the allocator's cache emptied, before it returns."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        fn(*args)
        torch.cuda.synchronize()
        used = int(torch.cuda.max_memory_allocated())
    except torch.cuda.OutOfMemoryError:
        used = -1
    torch.cuda.empty_cache()
    return used


def autobatch(make_fn: Callable[[int], Tuple[Callable, tuple]], max_batch: int = 128, fraction: float = 0.60,
              device=None, verbose: bool = True, probes: Optional[List[Tuple[int, int, int]]] = None) -> int:
    """Largest power-of-two batch whose step fits `fraction` of the card's memory.

    make_fn: batch size -> (fn, args), the probe step for that batch. `probes`, when given, gets one
    (batch, peak bytes, limit bytes) row per probe.
    """
    limit = int(device_memory_bytes(device) * fraction)
    best = 1
    b = 1
    while b <= max_batch:
        fn, args = make_fn(b)
        used = step_memory_bytes(fn, *args)
        if verbose:
            print(f"autobatch: batch={b} peak={used / 1e9:.2f} GB (limit {limit / 1e9:.2f} GB)")
        if probes is not None:
            probes.append((b, used, limit))
        if used < 0 or used > limit:
            break
        best = b
        b *= 2
    return best
