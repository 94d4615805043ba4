"""Per-point GICP covariance estimation, PLANE-regularized, batched.

Reference: ``nano_gicp_impl.hpp:298-357`` (``calculate_covariances``): for
each point, take its k nearest neighbors, form the neighborhood covariance,
SVD it, and replace the singular values with ``(1, 1, 1e-3)``
(RegularizationMethod::PLANE, ``gicp/gicp_settings.hpp:47``).

Redesign: the regularized covariance depends only on the neighborhood's
*smallest eigenvector* (the local surface normal n):

    C_reg = R diag(1, 1, eps) R^T = I - (1 - eps) n n^T

so this module computes and stores only ``normals [N, 3]`` — 3x less memory
traffic than 3x3 covariances and exactly equivalent under PLANE. Covariances
are rebuilt on the fly where the Mahalanobis weights need them.

The reference divides by k even when fewer neighbors are returned
(``nano_gicp_impl.hpp:319``); normals are scale-invariant so masked
mean/cov here divide by the true count, which only changes degenerate
cases for the better.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from direct_lidar_odometry_tpu.ops import eigh3, hashgrid

PLANE_EPS = 1e-3  # reference nano_gicp_impl.hpp:339: values = (1, 1, 1e-3)


class Normals(NamedTuple):
    normals: jnp.ndarray  # [N, 3] unit normals (arbitrary sign)
    valid: jnp.ndarray    # [N] bool — enough neighbors to estimate


def _normals_from_knn(points, kidx, kvalid, mask, min_neighbors):
    idx = jnp.clip(kidx, 0, None)
    neigh = points[idx]  # [N, k, 3] — gather from original order
    w = kvalid.astype(jnp.float32)[..., None]  # [N, k, 1]
    cnt = jnp.maximum(jnp.sum(w, axis=-2), 1.0)  # [N, 1]
    mean = jnp.sum(neigh * w, axis=-2) / cnt
    centered = (neigh - mean[..., None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    normal, _ = eigh3.smallest_eigvec3(cov)
    found = jnp.sum(kvalid, axis=-1)
    valid = mask & (found >= min_neighbors)
    normal = jnp.where(valid[..., None], normal, jnp.asarray([0.0, 0.0, 1.0]))
    return normal, valid, found


def estimate_normals(
    grid: hashgrid.HashGrid,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    cap: int,
    chunk: int = 4096,
    min_neighbors: int = 3,
    far_grid: hashgrid.HashGrid | None = None,
    far_cap: int = 32,
) -> Normals:
    """Surface normal per point from its k-NN neighborhood.

    The reference's kd-tree kNN is unbounded (``nano_gicp_impl.hpp:313``)
    and silently adapts to sparse regions; a hash-grid window does not. So
    this runs a *two-scale* search: the fine ``grid`` (cell ~ dense-region
    k-neighborhood) plus an optional coarse ``far_grid`` (cell several x
    larger); points whose fine window holds fewer than k neighbors take
    the coarse result. Without the fallback, sparse-region normals degrade
    enough to break GICP convergence from poor initializations (verified
    empirically — 33deg p90 normal error on sparse synthetic scans).
    """
    kidx, _, kvalid = hashgrid.query_knn(grid, points, mask, k=k, cap=cap, chunk=chunk)
    normal, valid, found = _normals_from_knn(points, kidx, kvalid, mask, min_neighbors)
    if far_grid is not None:
        kidx2, _, kvalid2 = hashgrid.query_knn(
            far_grid, points, mask, k=k, cap=far_cap, chunk=chunk
        )
        normal2, valid2, _ = _normals_from_knn(points, kidx2, kvalid2, mask, min_neighbors)
        use_far = found < k
        normal = jnp.where(use_far[..., None], normal2, normal)
        valid = jnp.where(use_far, valid2, valid)
    return Normals(normals=normal, valid=valid)


def estimate_normals_brute(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    chunk: int = 2048,
    min_neighbors: int = 3,
) -> Normals:
    """Normals from exact unbounded k-NN via tiled brute force.

    Matches the reference's kd-tree semantics exactly
    (``nano_gicp_impl.hpp:313``, unbounded search) at O(N^2) distance
    work; the "brute" backend's normals (see ops/bruteforce.py).
    """
    from direct_lidar_odometry_tpu.ops import bruteforce

    kidx, _, kvalid = bruteforce.query_knn(points, mask, points, mask, k=k, chunk=chunk)
    normal, valid, _ = _normals_from_knn(points, kidx, kvalid, mask, min_neighbors)
    return Normals(normals=normal, valid=valid)


def estimate_normals_twoscale(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    k: int,
    cell: float = 1.0,
    far_cell: float = 3.0,
    table_size: int = 2 ** 14,
    cap: int = 64,
    far_cap: int = 32,
    chunk: int = 4096,
) -> Normals:
    """Convenience wrapper: build both grids over the cloud and estimate."""
    grid = hashgrid.build(points, mask, cell, table_size)
    far_grid = hashgrid.build(points, mask, far_cell, table_size)
    return estimate_normals(
        grid, points, mask, k=k, cap=cap, chunk=chunk,
        far_grid=far_grid, far_cap=far_cap,
    )


def cov_from_normal(n: jnp.ndarray, eps: float = PLANE_EPS) -> jnp.ndarray:
    """PLANE-regularized covariance from a unit normal: I - (1-eps) n n^T.

    [..., 3] -> [..., 3, 3].
    """
    eye = jnp.eye(3, dtype=n.dtype)
    outer = n[..., :, None] * n[..., None, :]
    return eye - (1.0 - eps) * outer
