"""NumPy/f64 oracle: a faithful reimplementation of the reference's
NanoGICP + LsqRegistration semantics (nano_gicp_impl.hpp /
lsq_registration_impl.hpp), using scipy cKDTree for exact NN.

Used to validate the JAX implementation's numerics and, run end-to-end,
as a CPU baseline. Written from the algorithm
description in SURVEY.md §3.3 — double precision throughout, matching the
reference's Eigen::Matrix4d pipeline.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

PLANE_EPS = 1e-3


def skew(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def so3_exp(w):
    theta = np.linalg.norm(w)
    k = skew(w)
    if theta < 1e-10:
        return np.eye(3) + k
    a = np.sin(theta) / theta
    b = (1 - np.cos(theta)) / theta**2
    return np.eye(3) + a * k + b * (k @ k)


def plane_covariances(points: np.ndarray, k: int) -> np.ndarray:
    """Per-point PLANE-regularized covariance (nano_gicp_impl.hpp:298-357)."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=k)
    covs = np.zeros((len(points), 3, 3))
    for i in range(len(points)):
        neigh = points[idx[i]]
        neigh = neigh - neigh.mean(axis=0)
        cov = neigh.T @ neigh / k
        u, s, vt = np.linalg.svd(cov)
        covs[i] = u @ np.diag([1.0, 1.0, PLANE_EPS]) @ vt
    return covs


def normals_from_covariances(points: np.ndarray, k: int) -> np.ndarray:
    tree = cKDTree(points)
    _, idx = tree.query(points, k=k)
    normals = np.zeros((len(points), 3))
    for i in range(len(points)):
        neigh = points[idx[i]]
        neigh = neigh - neigh.mean(axis=0)
        cov = neigh.T @ neigh / k
        w, v = np.linalg.eigh(cov)
        normals[i] = v[:, 0]
    return normals


class OracleGICP:
    """LM-based GICP mirroring LsqRegistration defaults."""

    def __init__(
        self,
        max_corr_dist=1.0,
        max_iterations=32,
        transformation_epsilon=0.01,
        rotation_epsilon=2e-3,
        lm_max_iterations=10,
        lm_init_lambda_factor=1e-9,
        optimizer="lm",
    ):
        self.max_corr_dist = max_corr_dist
        self.max_iterations = max_iterations
        self.transformation_epsilon = transformation_epsilon
        self.rotation_epsilon = rotation_epsilon
        self.lm_max_iterations = lm_max_iterations
        self.lm_init_lambda_factor = lm_init_lambda_factor
        self.optimizer = optimizer
        self.iterations_run = 0
        self.converged = False

    def set_target(self, points: np.ndarray, covs: np.ndarray):
        self.tgt = np.asarray(points, np.float64)
        self.tgt_covs = covs
        self.tree = cKDTree(self.tgt)

    def set_source(self, points: np.ndarray, covs: np.ndarray):
        self.src = np.asarray(points, np.float64)
        self.src_covs = covs

    # --- internals -------------------------------------------------------
    def _update_correspondences(self, T):
        p_t = self.src @ T[:3, :3].T + T[:3, 3]
        d, j = self.tree.query(p_t, k=1)
        ok = d < self.max_corr_dist
        mahal = np.zeros((len(self.src), 3, 3))
        for i in np.nonzero(ok)[0]:
            rcr = self.tgt_covs[j[i]] + T[:3, :3] @ self.src_covs[i] @ T[:3, :3].T
            mahal[i] = np.linalg.inv(rcr)
        self.corr = np.where(ok, j, -1)
        self.mahal = mahal

    def _linearize(self, T):
        self._update_correspondences(T)
        H = np.zeros((6, 6))
        b = np.zeros(6)
        err = 0.0
        p_t = self.src @ T[:3, :3].T + T[:3, 3]
        for i in np.nonzero(self.corr >= 0)[0]:
            e = self.tgt[self.corr[i]] - p_t[i]
            m = self.mahal[i]
            err += e @ m @ e
            J = np.concatenate([skew(p_t[i]), -np.eye(3)], axis=1)  # 3x6
            H += J.T @ m @ J
            b += J.T @ m @ e
        return H, b, err

    def _compute_error(self, T):
        p_t = self.src @ T[:3, :3].T + T[:3, 3]
        err = 0.0
        for i in np.nonzero(self.corr >= 0)[0]:
            e = self.tgt[self.corr[i]] - p_t[i]
            err += e @ self.mahal[i] @ e
        return err

    def _is_converged(self, delta):
        r = np.abs(delta[:3, :3] - np.eye(3)) / self.rotation_epsilon
        t = np.abs(delta[:3, 3]) / self.transformation_epsilon
        return max(r.max(), t.max()) < 1

    @staticmethod
    def _exp_delta(d):
        out = np.eye(4)
        out[:3, :3] = so3_exp(d[:3])
        out[:3, 3] = d[3:]
        return out

    def align(self, guess=np.eye(4)):
        x0 = np.asarray(guess, np.float64).copy()
        lm_lambda = -1.0
        self.converged = False
        self.lm_failed = False
        for it in range(self.max_iterations):
            self.iterations_run = it + 1
            if self.optimizer == "gn":
                H, b, _ = self._linearize(x0)
                d = np.linalg.solve(H, -b)
                delta = self._exp_delta(d)
                x0 = delta @ x0
                self.final_hessian = H
            else:
                H, b, y0 = self._linearize(x0)
                if lm_lambda < 0:
                    lm_lambda = self.lm_init_lambda_factor * np.abs(np.diag(H)).max()
                nu = 2.0
                ok = False
                for _ in range(self.lm_max_iterations):
                    d = np.linalg.solve(H + lm_lambda * np.eye(6), -b)
                    delta = self._exp_delta(d)
                    xi = delta @ x0
                    yi = self._compute_error(xi)
                    rho = (y0 - yi) / (d @ (lm_lambda * d - b))
                    if rho < 0:
                        if self._is_converged(delta):
                            ok = True
                            break
                        lm_lambda *= nu
                        nu *= 2
                        continue
                    x0 = xi
                    lm_lambda *= max(1 / 3, 1 - (2 * rho - 1) ** 3)
                    self.final_hessian = H
                    ok = True
                    break
                if not ok:
                    self.lm_failed = True
                    break
            if self._is_converged(delta):
                self.converged = True
                break
        return x0
