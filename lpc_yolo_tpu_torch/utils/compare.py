"""Tie-tolerant comparison of two detection sets (used by the parity tests and chip_smoke.py).

Two runs of the same model in different arithmetic (JAX vs torch, kernel vs
plain) agree up to rounding, so detections whose scores are equal within the
tolerance may come out in another order, and the rows at the top-k cutoff may
swap in or out. The check therefore compares the sorted scores, then matches
every row above the cutoff band to a row of the other set with the same
label, a score within `atol_score` and a box within `atol_box`.
"""

from __future__ import annotations

import numpy as np


def assert_detections_close(a: np.ndarray, b: np.ndarray, atol_box: float, atol_score: float) -> None:
    """a, b: (N, 6) [x1, y1, x2, y2, score, label] rows of one image. Raises AssertionError."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape[1:] != (6,) or b.shape[1:] != (6,):
        raise AssertionError(f"expected (N, 6) detections, got {a.shape} and {b.shape}")
    n = min(len(a), len(b))
    sa, sb = np.sort(a[:, 4])[::-1][:n], np.sort(b[:, 4])[::-1][:n]
    if not np.allclose(sa, sb, rtol=0, atol=atol_score):
        raise AssertionError(f"sorted scores differ by {np.abs(sa - sb).max():.3g} > {atol_score}")
    if n == 0:
        return
    lo = max(a[:, 4].min(), b[:, 4].min()) + 2 * atol_score  # rows below may cross the cutoff
    for x, y, which in ((a, b, "first"), (b, a, "second")):
        for row in x[x[:, 4] > lo]:
            cand = y[(y[:, 5] == row[5]) & (np.abs(y[:, 4] - row[4]) <= 2 * atol_score)]
            if not len(cand) or np.abs(cand[:, :4] - row[:4]).max(axis=1).min() > atol_box:
                raise AssertionError(f"row {row.tolist()} of the {which} set has no match within "
                                     f"box {atol_box} / score {atol_score}")


def assert_val_results_agree(got: dict, ref: dict, rtol: float = 1e-9) -> None:
    """Two validators' results dicts (the port's and the JAX package's on the same weights and data): the same
    keys in the same order; every key that only the ranks of the kept rows decide (each mAP key and fitness)
    equal to the last digit; the precision and recall keys within `rtol` of each other.

    Precision and recall are read off `np.interp` at the best-F1 point over the kept rows' confidences
    (`utils/metrics.py::ap_per_class`). XLA's CPU convolutions and torch's sum in another order, so a few of
    those confidences differ by one f32 unit in the last place, which moves the interpolated value by ~1e-10
    relative; the order of the rows, and with it every mAP, stays the same. Raises AssertionError."""
    if list(got) != list(ref):
        raise AssertionError(f"keys differ: {list(got)} != {list(ref)}")
    for k, a in got.items():
        b = ref[k]
        interpolated = k.startswith(("metrics/precision", "metrics/recall"))
        if (abs(a - b) > rtol * max(abs(a), abs(b))) if interpolated else (a != b):
            raise AssertionError(f"{k}: {a!r} != {b!r}" + (f" (rtol {rtol})" if interpolated else ""))
