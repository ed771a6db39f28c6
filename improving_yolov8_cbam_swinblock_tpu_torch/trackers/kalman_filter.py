"""Constant-velocity Kalman filters of the trackers: the port's copy of the
JAX package's trackers/kalman_filter.py, in numpy float64 as there.

An 8-dim state (centre, aspect or width, height, and their velocities),
chi-square gating distances, and the predict / update cycle. Host code by
design: a frame holds at most max_det boxes, and the association is
sequential per frame; the card detects, the host associates.
"""

from __future__ import annotations

import numpy as np

# 0.95 quantile of chi-square for gating, by degrees of freedom
chi2inv95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """State: (x, y, a, h, vx, vy, va, vh) — center, aspect ratio, height."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[3],
            1e-2,
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            1e-5,
            10 * self._std_weight_velocity * measurement[3],
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean):
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

    def predict(self, mean, covariance):
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + self._motion_cov(mean)
        return mean, covariance

    def multi_predict(self, means, covariances):
        """predict over N tracks at once."""
        if len(means) == 0:
            return means, covariances
        means = np.asarray(means)
        std_pos = np.stack(
            [
                self._std_weight_position * means[:, 3],
                self._std_weight_position * means[:, 3],
                1e-2 * np.ones(len(means)),
                self._std_weight_position * means[:, 3],
            ]
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * means[:, 3],
                self._std_weight_velocity * means[:, 3],
                1e-5 * np.ones(len(means)),
                self._std_weight_velocity * means[:, 3],
            ]
        )
        sqr = np.square(np.r_[std_pos, std_vel]).T
        motion_covs = np.array([np.diag(s) for s in sqr])
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ np.asarray(covariances) @ self._motion_mat.T + motion_covs
        return means, covariances

    def _project(self, mean, covariance):
        std = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-1,
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov

    def update(self, mean, covariance, measurement):
        proj_mean, proj_cov = self._project(mean, covariance)
        chol = np.linalg.cholesky(proj_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - proj_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ proj_cov @ kalman_gain.T
        return new_mean, new_cov

    def gating_distance(self, mean, covariance, measurements, only_position=False):
        proj_mean, proj_cov = self._project(mean, covariance)
        if only_position:
            proj_mean, proj_cov = proj_mean[:2], proj_cov[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - proj_mean
        chol = np.linalg.cholesky(proj_cov)
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State: (x, y, w, h, vx, vy, vw, vh), used by BoT-SORT."""

    def initiate(self, measurement):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov(self, mean):
        std_pos = [
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
        ]
        std_vel = [
            self._std_weight_velocity * mean[2],
            self._std_weight_velocity * mean[3],
            self._std_weight_velocity * mean[2],
            self._std_weight_velocity * mean[3],
        ]
        return np.diag(np.square(np.r_[std_pos, std_vel]))

    def multi_predict(self, means, covariances):
        if len(means) == 0:
            return means, covariances
        means = np.asarray(means)
        std_pos = np.stack(
            [
                self._std_weight_position * means[:, 2],
                self._std_weight_position * means[:, 3],
                self._std_weight_position * means[:, 2],
                self._std_weight_position * means[:, 3],
            ]
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * means[:, 2],
                self._std_weight_velocity * means[:, 3],
                self._std_weight_velocity * means[:, 2],
                self._std_weight_velocity * means[:, 3],
            ]
        )
        sqr = np.square(np.r_[std_pos, std_vel]).T
        motion_covs = np.array([np.diag(s) for s in sqr])
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ np.asarray(covariances) @ self._motion_mat.T + motion_covs
        return means, covariances

    def _project(self, mean, covariance):
        std = [
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov
