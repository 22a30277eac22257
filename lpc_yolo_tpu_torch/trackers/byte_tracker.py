"""ByteTrack: two-stage IoU association over Kalman-predicted tracks (counterpart of
`lpc_yolo_tpu/trackers/byte_tracker.py:20-312`: TrackState, STrack, BYTETracker,
joint_stracks, sub_stracks, remove_duplicate_stracks).

Each frame: the detections at or above `track_high_thresh` are matched to the
predicted tracks (IoU fused with the score), those above `track_low_thresh`
rescue the tracks left over, unconfirmed tracks take what remains, a
detection at or above `new_track_thresh` starts a track, and a track lost for
more than `track_buffer` frames (at 30 fps) is dropped. Host numpy, the JAX
package's code: on the same detections the rows are bitwise the JAX ones.
Track ids come from the class counter `STrack._count`, which every new
tracker and `reset()` set back to 0, as in the JAX package and the reference.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import matching
from .kalman_filter import KalmanFilterXYAH


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xyxy: np.ndarray, score: float, cls: int):
        x1, y1, x2, y2 = xyxy
        # stored as tlwh internally like the reference
        self._tlwh = np.array([x1, y1, x2 - x1, y2 - y1], np.float32)
        self.score = float(score)
        self.cls = int(cls)
        self.kalman_filter: Optional[KalmanFilterXYAH] = None
        self.mean, self.covariance = None, None
        self.state = TrackState.New
        self.is_activated = False
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0
        self.idx = -1  # detection row index for Results bookkeeping

    @staticmethod
    def next_id() -> int:
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    # --- geometry
    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        x, y, a, h = self.mean[:4]
        w = a * h
        return np.array([x - w / 2, y - h / 2, w, h], np.float32)

    @property
    def xyxy(self) -> np.ndarray:
        t = self.tlwh
        return np.array([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @staticmethod
    def tlwh_to_xyah(tlwh: np.ndarray) -> np.ndarray:
        x, y, w, h = tlwh
        return np.array([x + w / 2, y + h / 2, w / max(h, 1e-6), h], np.float32)

    # --- lifecycle
    def activate(self, kalman_filter, frame_id: int):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track: "STrack", frame_id: int, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track: "STrack", frame_id: int):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track._tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks: List["STrack"]):
        if not stracks:
            return
        means = np.stack([t.mean.copy() for t in stracks])
        covs = np.stack([t.covariance for t in stracks])
        for i, t in enumerate(stracks):
            if t.state != TrackState.Tracked:
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for t, m, c in zip(stracks, means, covs):
            t.mean, t.covariance = m, c

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self) -> int:
        return self.frame_id


class BYTETracker:
    """Two-stage association tracker (byte_tracker.py:212-430)."""

    def __init__(
        self,
        track_high_thresh: float = 0.5,
        track_low_thresh: float = 0.1,
        new_track_thresh: float = 0.6,
        track_buffer: int = 30,
        match_thresh: float = 0.8,
        fuse_score: bool = True,
        frame_rate: int = 30,
        **_,
    ):
        self.tracked_stracks: List[STrack] = []
        self.lost_stracks: List[STrack] = []
        self.removed_stracks: List[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.do_fuse_score = fuse_score
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, boxes, scores, classes, img=None) -> List[STrack]:
        tracks = [STrack(b, s, c) for b, s, c in zip(boxes, scores, classes)]
        return tracks

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        if self.do_fuse_score:
            dists = matching.fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def apply_gmc(self, strack_pool, unconfirmed, img):
        """Camera-motion hook; no-op for plain ByteTrack (BoT-SORT overrides)."""

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray, img=None) -> np.ndarray:
        """One frame. boxes (N,4) xyxy. Returns (K, 8):
        [x1, y1, x2, y2, track_id, score, cls, det_idx]."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []

        high = scores >= self.track_high_thresh
        low = (scores > self.track_low_thresh) & ~high
        dets = self.init_track(boxes[high], scores[high], classes[high], img)
        for t, i in zip(dets, np.nonzero(high)[0]):
            t.idx = int(i)
        dets_low = self.init_track(boxes[low], scores[low], classes[low], img)
        for t, i in zip(dets_low, np.nonzero(low)[0]):
            t.idx = int(i)

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)

        # 1) predict (+ camera-motion warp in BoT-SORT) + high-conf association
        self.multi_predict(strack_pool)
        self.apply_gmc(strack_pool, unconfirmed, img)
        dists = self.get_dists(strack_pool, dets)
        matches, u_track, u_detection = matching.linear_assignment(dists, self.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], dets[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # 2) low-conf rescue on remaining previously-tracked tracks
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, dets_low)
        matches, u_track2, _ = matching.linear_assignment(dists, 0.5)
        for it, idet in matches:
            track, det = r_tracked[it], dets_low[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for i in u_track2:
            track = r_tracked[i]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # 3) unconfirmed tracks vs remaining high dets
        dets_left = [dets[i] for i in u_detection]
        dists = self.get_dists(unconfirmed, dets_left)
        matches, u_unconfirmed, u_detection2 = matching.linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(dets_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconfirmed:
            track = unconfirmed[i]
            track.mark_removed()
            removed.append(track)

        # 4) new tracks
        for i in u_detection2:
            track = dets_left[i]
            if track.score >= self.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # 5) expire lost
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        out = [
            np.concatenate([t.xyxy, [t.track_id, t.score, t.cls, t.idx]])
            for t in self.tracked_stracks
            if t.is_activated
        ]
        return np.stack(out) if out else np.zeros((0, 8), np.float32)

    def reset(self):
        self.tracked_stracks, self.lost_stracks, self.removed_stracks = [], [], []
        self.frame_id = 0
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()


def joint_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a: List[STrack], b: List[STrack]) -> List[STrack]:
    bids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in bids]


def remove_duplicate_stracks(a: List[STrack], b: List[STrack]):
    pdist = matching.iou_distance(a, b)
    pairs = np.nonzero(pdist < 0.15)
    dup_a, dup_b = set(), set()
    for p, q in zip(*pairs):
        timep = a[p].frame_id - a[p].start_frame
        timeq = b[q].frame_id - b[q].start_frame
        if timep > timeq:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return [t for i, t in enumerate(a) if i not in dup_a], [t for i, t in enumerate(b) if i not in dup_b]
