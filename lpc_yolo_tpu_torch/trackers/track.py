"""The trackers behind `YOLO.track` (counterpart of `lpc_yolo_tpu/trackers/track.py:1-61`).

`make_tracker` builds ByteTrack or BoT-SORT from a config name
(`cfg/trackers/bytetrack.yaml`, `botsort.yaml`), a path or a dict, with a
ReID encoder when `with_reid` asks for one (`reid.py`; a `cnn` encoder on
`device`). `track_stream` feeds each Results' detections to a tracker and
yields the Results with the rows of the tracks confirmed on that frame,
[x1, y1, x2, y2, id, conf, cls]. It takes a built tracker too, so that
`YOLO.track(..., persist=True)` goes on with the tracker of its last call.
The frame rate is 30, as in the JAX package and the reference.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Iterator, Union

import numpy as np
import torch
import yaml

from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}
_CFG_DIR = Path(__file__).resolve().parents[1] / "cfg" / "trackers"


def make_tracker(tracker: Union[str, Path, dict] = "bytetrack.yaml", frame_rate: int = 30,
                 device: Union[str, torch.device, None] = None):
    """A tracker from a config name, path or dict (`tracker_type` bytetrack or botsort, then the tracker's
    own keys; `reid_encoder` hist or cnn when `with_reid`)."""
    if isinstance(tracker, dict):
        cfg = dict(tracker)
    else:
        p = Path(tracker)
        if not p.exists():
            p = _CFG_DIR / p.name
        cfg = yaml.safe_load(p.read_text())
    ttype = cfg.pop("tracker_type", "bytetrack")
    if ttype not in TRACKER_MAP:
        raise ValueError(f"tracker_type must be one of {list(TRACKER_MAP)}, got {ttype}")
    if ttype == "botsort" and cfg.get("with_reid") and "encoder" not in cfg:
        from .reid import build_encoder

        kind = cfg.pop("reid_encoder", "hist")
        cfg["encoder"] = build_encoder(kind, device=device) if kind == "cnn" else build_encoder(kind)
    else:
        cfg.pop("reid_encoder", None)
    return TRACKER_MAP[ttype](frame_rate=frame_rate, **cfg)


def track_stream(results_iter: Iterable, tracker: Union[str, Path, dict, BYTETracker] = "bytetrack.yaml"
                 ) -> Iterator:
    """Each Results of the stream after `tracker.update` on its detections (a built tracker, or a config
    for `make_tracker`): its boxes become the confirmed tracks' rows [x1, y1, x2, y2, id, conf, cls]
    ((0, 7) when there are none)."""
    if not isinstance(tracker, BYTETracker):
        tracker = make_tracker(tracker)
    for r in results_iter:
        det = r.boxes.data if r.boxes is not None else np.zeros((0, 6), np.float32)
        tracks = tracker.update(det[:, :4], det[:, -2], det[:, -1], r.orig_img)
        rows = tracks[:, :7].astype(np.float32) if len(tracks) else np.zeros((0, 7), np.float32)
        r.update(boxes=rows)
        yield r
