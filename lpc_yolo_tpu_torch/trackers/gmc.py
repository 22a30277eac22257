"""Global (camera) motion compensation of BoT-SORT (counterpart of
`lpc_yolo_tpu/trackers/gmc.py:16-125`): a 2x3 affine warp between consecutive
frames, by which the tracker moves its predicted states.

`method: none` is the identity and needs nothing. `sparseOptFlow` (the
default of `botsort.yaml`: goodFeaturesToTrack, pyramidal Lucas-Kanade and a
RANSAC partial-affine fit on frames downscaled by 2), `ecc`, `orb` and `sift`
are OpenCV's estimators, imported lazily (`utils.require_cv2`); without cv2
they raise an ImportError, and never turn into `none`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import require_cv2

METHODS = ("sparseOptFlow", "ecc", "orb", "sift", "none", None)


class GMC:
    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        if method not in METHODS:  # the reference raises too; the JAX GMC returns the identity
            raise ValueError(f"unknown GMC method {method!r}, expected one of {METHODS}")
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prevFrame: Optional[np.ndarray] = None
        self.prevKeyPoints = None
        self.initializedFirstFrame = False

    def apply(self, raw_frame: np.ndarray, detections=None) -> np.ndarray:
        if self.method in ("sparseOptFlow",):
            return self.apply_sparseoptflow(raw_frame)
        if self.method in ("ecc",):
            return self.apply_ecc(raw_frame)
        if self.method in ("orb", "sift"):
            return self.apply_features(raw_frame, detections)
        return np.eye(2, 3)

    def _prep(self, raw_frame: np.ndarray) -> np.ndarray:
        cv2 = require_cv2("GMC's frame preparation")

        frame = cv2.cvtColor(raw_frame, cv2.COLOR_BGR2GRAY) if raw_frame.ndim == 3 else raw_frame
        if self.downscale > 1:
            h, w = frame.shape
            frame = cv2.resize(frame, (w // self.downscale, h // self.downscale))
        return frame

    def apply_sparseoptflow(self, raw_frame: np.ndarray) -> np.ndarray:
        cv2 = require_cv2("GMC sparseOptFlow")

        H = np.eye(2, 3)
        frame = self._prep(raw_frame)
        keypoints = cv2.goodFeaturesToTrack(
            frame, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3,
            useHarrisDetector=False, k=0.04,
        )
        if not self.initializedFirstFrame or keypoints is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = keypoints
            self.initializedFirstFrame = True
            return H
        if self.prevKeyPoints is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = keypoints
            return H
        matched, status, _ = cv2.calcOpticalFlowPyrLK(self.prevFrame, frame, self.prevKeyPoints, None)
        prev_pts = self.prevKeyPoints[status.ravel() == 1] if status is not None else np.empty((0, 1, 2))
        curr_pts = matched[status.ravel() == 1] if status is not None else np.empty((0, 1, 2))
        if len(prev_pts) > 4:
            M, _ = cv2.estimateAffinePartial2D(prev_pts, curr_pts, method=cv2.RANSAC)
            if M is not None:
                H = M
                if self.downscale > 1:
                    H[0, 2] *= self.downscale
                    H[1, 2] *= self.downscale
        self.prevFrame = frame.copy()
        self.prevKeyPoints = keypoints
        return H

    def apply_ecc(self, raw_frame: np.ndarray) -> np.ndarray:
        cv2 = require_cv2("GMC ecc")

        H = np.eye(2, 3, dtype=np.float32)
        frame = self._prep(raw_frame)
        if not self.initializedFirstFrame:
            self.prevFrame = frame.copy()
            self.initializedFirstFrame = True
            return H
        criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-6)
        try:
            _, H = cv2.findTransformECC(self.prevFrame, frame, H, cv2.MOTION_EUCLIDEAN, criteria, None, 1)
        except cv2.error:
            pass
        self.prevFrame = frame.copy()
        return H

    def apply_features(self, raw_frame: np.ndarray, detections=None) -> np.ndarray:
        cv2 = require_cv2("GMC orb and sift")

        H = np.eye(2, 3)
        frame = self._prep(raw_frame)
        detector = cv2.ORB_create() if self.method == "orb" else cv2.SIFT_create()
        kp, desc = detector.detectAndCompute(frame, None)
        if not self.initializedFirstFrame or desc is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = (kp, desc)
            self.initializedFirstFrame = True
            return H
        pkp, pdesc = self.prevKeyPoints
        if pdesc is not None and len(pdesc) > 0 and len(desc) > 0:
            norm = cv2.NORM_HAMMING if self.method == "orb" else cv2.NORM_L2
            matcher = cv2.BFMatcher(norm)
            matches = matcher.knnMatch(pdesc, desc, k=2)
            good = [m for pair in matches if len(pair) == 2 for m, n in [pair] if m.distance < 0.75 * n.distance]
            if len(good) > 4:
                prev_pts = np.float32([pkp[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
                curr_pts = np.float32([kp[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
                M, _ = cv2.estimateAffinePartial2D(prev_pts, curr_pts, method=cv2.RANSAC)
                if M is not None:
                    H = M
                    if self.downscale > 1:
                        H[0, 2] *= self.downscale
                        H[1, 2] *= self.downscale
        self.prevFrame = frame.copy()
        self.prevKeyPoints = (kp, desc)
        return H

    def reset_params(self):
        self.prevFrame = None
        self.prevKeyPoints = None
        self.initializedFirstFrame = False
