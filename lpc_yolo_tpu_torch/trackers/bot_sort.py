"""BoT-SORT: ByteTrack with camera-motion compensation and an optional appearance cue (counterpart of
`lpc_yolo_tpu/trackers/bot_sort.py:21-138`: BOTrack, BOTSORT).

A BOTrack keeps its state in xywh (`KalmanFilterXYWH`) and, with ReID, a
smoothed unit feature (alpha 0.9); each frame the predicted states are warped
by `GMC`'s affine, and the cost is the score-fused IoU, or where ReID is on
the lesser of it and half the cosine distance of the features (1 where that
exceeds `appearance_thresh` or the IoU is under `proximity_thresh`). The
encoder is a callable `encoder(frame, boxes) -> (N, D)` (`reid.py`). Host
numpy, the JAX package's code.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import matching
from .byte_tracker import BYTETracker, STrack, TrackState
from .gmc import GMC
from .kalman_filter import KalmanFilterXYWH


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xyxy, score, cls, feat: Optional[np.ndarray] = None, feat_history: int = 50):
        super().__init__(xyxy, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        self.alpha = 0.9
        if feat is not None:
            self.update_features(feat)

    def update_features(self, feat: np.ndarray):
        feat = feat / (np.linalg.norm(feat) + 1e-12)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-12

    @staticmethod
    def tlwh_to_xyah(tlwh: np.ndarray) -> np.ndarray:
        """BoT-SORT uses xywh measurements (center + size)."""
        x, y, w, h = tlwh
        return np.array([x + w / 2, y + h / 2, w, h], np.float32)

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        x, y, w, h = self.mean[:4]
        return np.array([x - w / 2, y - h / 2, w, h], np.float32)

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[6] = 0
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks: List["BOTrack"]):
        if not stracks:
            return
        means = np.stack([t.mean.copy() for t in stracks])
        covs = np.stack([t.covariance for t in stracks])
        for i, t in enumerate(stracks):
            if t.state != TrackState.Tracked:
                means[i][6] = 0
                means[i][7] = 0
        means, covs = BOTrack.shared_kalman.multi_predict(means, covs)
        for t, m, c in zip(stracks, means, covs):
            t.mean, t.covariance = m, c

    @staticmethod
    def multi_gmc(stracks: List["BOTrack"], H: np.ndarray):
        """Warp track states by the camera-motion affine (bot_sort.py multi_gmc)."""
        if not stracks:
            return
        R = H[:2, :2]
        R8 = np.kron(np.eye(4), R)
        t = H[:2, 2]
        for track in stracks:
            mean = R8 @ track.mean
            mean[:2] += t
            track.mean = mean
            track.covariance = R8 @ track.covariance @ R8.T


class BOTSORT(BYTETracker):
    def __init__(
        self,
        proximity_thresh: float = 0.5,
        appearance_thresh: float = 0.25,
        gmc_method: str = "sparseOptFlow",
        with_reid: bool = False,
        encoder=None,
        **kw,
    ):
        super().__init__(**kw)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid and encoder is not None
        self.encoder = encoder
        self.gmc = GMC(method=gmc_method)

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, boxes, scores, classes, img=None) -> List[BOTrack]:
        if len(boxes) == 0:
            return []
        if self.with_reid and img is not None:
            feats = self.encoder(img, boxes)
            return [BOTrack(b, s, c, f) for b, s, c, f in zip(boxes, scores, classes, feats)]
        return [BOTrack(b, s, c) for b, s, c in zip(boxes, scores, classes)]

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        dists = matching.fuse_score(dists, detections)
        if self.with_reid:
            emb = matching.embedding_distance(tracks, detections) / 2.0
            emb[emb > self.appearance_thresh] = 1.0
            emb[dists_mask] = 1.0
            dists = np.minimum(dists, emb)
        return dists

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def apply_gmc(self, strack_pool, unconfirmed, img):
        """Warp predicted track states by camera motion (byte_tracker.py:280s)."""
        if img is not None:
            H = self.gmc.apply(img)
            BOTrack.multi_gmc(strack_pool, H)
            BOTrack.multi_gmc(unconfirmed, H)

    def reset(self):
        super().reset()
        self.gmc.reset_params()
