"""Constant-velocity Kalman filters of the trackers (counterpart of
`lpc_yolo_tpu/trackers/kalman_filter.py`: KalmanFilterXYAH :16 for ByteTrack,
KalmanFilterXYWH :127 for BoT-SORT).

Host numpy in float64, the JAX package's operations in its order, so a
tracker's states, and the boxes it reports, are bitwise those of the JAX
trackers on the same detections: an 8-dim state [centre, aspect or width,
height, their velocities], noise scaled by the height (weights 1/20 for
position, 1/160 for velocity), the update through a Cholesky solve.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class KalmanFilterXYAH:
    """State: [x, y, a, h, vx, vy, va, vh] (a = aspect ratio w/h)."""

    ndim = 4

    def __init__(self):
        dt = 1.0
        self._motion_mat = np.eye(2 * self.ndim)
        for i in range(self.ndim):
            self._motion_mat[i, self.ndim + i] = dt
        self._update_mat = np.eye(self.ndim, 2 * self.ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _std_pos(self, m) -> list:
        return [
            2 * self._std_weight_position * m[3],
            2 * self._std_weight_position * m[3],
            1e-2,
            2 * self._std_weight_position * m[3],
        ]

    def _std_vel(self, m) -> list:
        return [
            10 * self._std_weight_velocity * m[3],
            10 * self._std_weight_velocity * m[3],
            1e-5,
            10 * self._std_weight_velocity * m[3],
        ]

    def initiate(self, measurement: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean = np.r_[measurement, np.zeros_like(measurement)]
        std = self._std_pos(measurement) + self._std_vel(measurement)
        covariance = np.diag(np.square(std))
        return mean, covariance

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        std_pos = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-2,
            self._std_weight_position * mean[3],
        ]
        std_vel = [
            self._std_weight_velocity * mean[3],
            self._std_weight_velocity * mean[3],
            1e-5,
            self._std_weight_velocity * mean[3],
        ]
        return np.diag(np.square(np.r_[std_pos, std_vel]))

    def predict(self, mean: np.ndarray, covariance: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        motion_cov = self._motion_cov(mean)
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, means: np.ndarray, covariances: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized predict over N tracks (kalman_filter.py multi_predict)."""
        if len(means) == 0:
            return means, covariances
        std_pos = np.stack(
            [
                self._std_weight_position * means[:, 3],
                self._std_weight_position * means[:, 3],
                1e-2 * np.ones_like(means[:, 3]),
                self._std_weight_position * means[:, 3],
            ],
            axis=-1,
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * means[:, 3],
                self._std_weight_velocity * means[:, 3],
                1e-5 * np.ones_like(means[:, 3]),
                self._std_weight_velocity * means[:, 3],
            ],
            axis=-1,
        )
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=-1))
        motion_covs = np.stack([np.diag(s) for s in sqr])
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ covariances @ self._motion_mat.T + motion_covs
        return means, covariances

    def project(self, mean: np.ndarray, covariance: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        std = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-1,
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def update(
        self, mean: np.ndarray, covariance: np.ndarray, measurement: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        projected_mean, projected_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(projected_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_cov


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State: [x, y, w, h, ...] — BoT-SORT variant (kalman_filter.py:219)."""

    def _wh_stds(self, m, w_pos):
        return [w_pos * m[2], w_pos * m[3], w_pos * m[2], w_pos * m[3]]

    def initiate(self, measurement: np.ndarray):
        mean = np.r_[measurement, np.zeros_like(measurement)]
        std = self._wh_stds(measurement, 2 * self._std_weight_position) + self._wh_stds(
            measurement, 10 * self._std_weight_velocity
        )
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        std = self._wh_stds(mean, self._std_weight_position) + self._wh_stds(
            mean, self._std_weight_velocity
        )
        return np.diag(np.square(std))

    def multi_predict(self, means: np.ndarray, covariances: np.ndarray):
        if len(means) == 0:
            return means, covariances
        w_p, w_v = self._std_weight_position, self._std_weight_velocity
        std = np.stack(
            [
                w_p * means[:, 2], w_p * means[:, 3], w_p * means[:, 2], w_p * means[:, 3],
                w_v * means[:, 2], w_v * means[:, 3], w_v * means[:, 2], w_v * means[:, 3],
            ],
            axis=-1,
        )
        motion_covs = np.stack([np.diag(s) for s in np.square(std)])
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ covariances @ self._motion_mat.T + motion_covs
        return means, covariances

    def project(self, mean: np.ndarray, covariance: np.ndarray):
        std = self._wh_stds(mean, self._std_weight_position)
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov
