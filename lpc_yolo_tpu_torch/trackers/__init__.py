"""Multi-object trackers: ByteTrack and BoT-SORT (camera-motion compensation, ReID), the Kalman filters,
and `track_stream` behind `YOLO.track` (counterpart of `lpc_yolo_tpu/trackers/`)."""

from .bot_sort import BOTSORT, BOTrack
from .byte_tracker import BYTETracker, STrack
from .track import make_tracker, track_stream

__all__ = ["BOTSORT", "BOTrack", "BYTETracker", "STrack", "make_tracker", "track_stream"]
