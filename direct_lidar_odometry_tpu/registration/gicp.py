"""GICP registration: fused correspondence + Mahalanobis + Gauss-Newton /
Levenberg-Marquardt on SE(3), as a ``lax.while_loop`` program.

Functional redesign of the reference's registration engine:

- ``NanoGICP::update_correspondences`` (``nano_gicp_impl.hpp:173-211``):
  per-iteration 1-NN of the transformed source in the target, gated by
  ``max_correspondence_distance``, plus Mahalanobis weights
  ``M = (C_B + T C_A T^T)^{-1}``. Here the OpenMP loop becomes the
  hash-grid 1-NN kernel + batched analytic 3x3 inverses; PLANE covariances
  are rebuilt from stored normals (see registration/covariance.py).
- ``NanoGICP::linearize`` (``:213-270``): per-point residual
  ``e = mu_B - T mu_A``, Jacobian ``J = [skew(T mu_A) | -I]``, and the
  H/b accumulation — a masked einsum reduction instead of per-thread
  partial sums.
- ``NanoGICP::compute_error`` (``:272-296``): error re-evaluation with
  *frozen* correspondences, used by the LM gain-ratio test.
- ``LsqRegistration::computeTransformation`` + ``step_gn``/``step_lm``
  (``lsq_registration_impl.hpp:89-208``): outer iteration and the damped
  solver, reproduced including the LM lambda/nu backoff schedule, the
  ``rho`` gain test, and the exact convergence test
  ``max(|R-I|/rot_eps, |t|/trans_eps) < 1`` (``:118-127``).

Everything is f32 with static shapes; the 6x6 solve is a dense
``jnp.linalg.solve``. The while_loops stop early on convergence, so average
iteration count matches the reference's data-dependent loop.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import GicpStageConfig
from direct_lidar_odometry_tpu.core import se3
from direct_lidar_odometry_tpu.ops import bruteforce, hashgrid
from direct_lidar_odometry_tpu.registration.covariance import PLANE_EPS, cov_from_normal
from direct_lidar_odometry_tpu.utils.precision import f32_matmuls


class GicpTarget(NamedTuple):
    """A registration target in original point order.

    ``grid`` is the hash index for the "hashgrid" backend (the role of the
    reference's kd-tree build, ``nano_gicp_impl.hpp:127,137``) and
    ``None`` for the "brute" backend (tiled exhaustive search needs no
    index).
    """

    points: jnp.ndarray         # [Nt, 3]
    mask: jnp.ndarray           # [Nt]
    normals: jnp.ndarray        # [Nt, 3]
    normals_valid: jnp.ndarray  # [Nt]
    grid: hashgrid.HashGrid | None


class GicpSource(NamedTuple):
    points: jnp.ndarray         # [Ns, 3]
    mask: jnp.ndarray           # [Ns]
    normals: jnp.ndarray        # [Ns, 3]
    normals_valid: jnp.ndarray  # [Ns]


class GicpResult(NamedTuple):
    transform: jnp.ndarray       # [4, 4] final estimate
    hessian: jnp.ndarray         # [6, 6] final accepted H (health/fusion input)
    iterations: jnp.ndarray      # int32, outer iterations executed
    converged: jnp.ndarray       # bool
    lm_failed: jnp.ndarray       # bool ("lm not converged!!" analog)
    final_error: jnp.ndarray     # f32, last linearization error sum
    num_correspondences: jnp.ndarray  # int32 at the last linearization


def make_target(
    points, mask, normals, normals_valid, radius, table_size,
    backend: str = "hashgrid",
) -> GicpTarget:
    """Build the per-backend search index over the target cloud."""
    grid = (
        hashgrid.build(points, mask, radius, table_size)
        if backend == "hashgrid"
        else None
    )
    return GicpTarget(
        points=points, mask=mask, normals=normals,
        normals_valid=normals_valid, grid=grid,
    )


def _sym_inv3(m: jnp.ndarray) -> jnp.ndarray:
    """Analytic inverse of symmetric [..., 3, 3] via adjugate (elementwise,
    fusable)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e = m[..., 1, 1], m[..., 1, 2]
    f = m[..., 2, 2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    i00 = co_a * inv_det
    i01 = co_b * inv_det
    i02 = co_c * inv_det
    i11 = (a * f - c * c) * inv_det
    i12 = (b * c - a * e) * inv_det
    i22 = (a * d - b * b) * inv_det
    row0 = jnp.stack([i00, i01, i02], axis=-1)
    row1 = jnp.stack([i01, i11, i12], axis=-1)
    row2 = jnp.stack([i02, i12, i22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


class _Linearization(NamedTuple):
    h: jnp.ndarray           # [6, 6]
    b: jnp.ndarray           # [6]
    error: jnp.ndarray       # scalar
    corr: jnp.ndarray        # [Ns] int32 target index (-1 = none)
    weight: jnp.ndarray      # [Ns] f32 0/1 correspondence mask
    mu_b: jnp.ndarray        # [Ns, 3] frozen correspondence target points
    n_b: jnp.ndarray         # [Ns, 3] frozen correspondence target normals
    m0: jnp.ndarray          # [Ns, 3] source normals rotated by the frozen R
    n_corr: jnp.ndarray      # int32


def _update_correspondences(
    x0: jnp.ndarray, src: GicpSource, target: GicpTarget, cfg: GicpStageConfig,
    cap: int, backend: str,
):
    """1-NN + Mahalanobis. Reference nano_gicp_impl.hpp:173-211."""
    r = x0[:3, :3]
    p_t = se3.transform_points(x0, src.points)  # [Ns, 3]
    if backend == "brute":
        tile = min(8192, target.points.shape[0])
        idx, _, found = bruteforce.query_1nn(
            target.points, target.mask, p_t, src.mask,
            cfg.max_correspondence_distance, tile=tile,
        )
    else:
        idx, _, found = hashgrid.query_1nn(
            target.grid, p_t, src.mask, cfg.max_correspondence_distance, cap
        )
    j = jnp.clip(idx, 0, None)
    # both endpoints need usable normals; reference has covariances for all
    # points unconditionally, ours are masked (see covariance.py docstring)
    ok = found & src.normals_valid & target.normals_valid[j]
    # C_B + R C_A R^T = 2 I - (1-eps)(nB nB^T + (R nA)(R nA)^T)
    n_a_rot = src.normals @ r.T
    n_b = target.normals[j]
    rcr = cov_from_normal(n_b) + cov_from_normal(n_a_rot)
    mahal = _sym_inv3(rcr)
    w = ok.astype(jnp.float32)
    mahal = mahal * w[..., None, None]
    corr = jnp.where(ok, j, -1)
    return corr, w, mahal, p_t, n_b, n_a_rot


def _linearize(
    x0: jnp.ndarray, src: GicpSource, target: GicpTarget, cfg, cap, backend,
) -> _Linearization:
    """Reference nano_gicp_impl.hpp:213-270: 1-NN query, then one fused
    masked einsum reduction for H, b and the error."""
    corr, weight, mahal, p_t, n_b, m0 = _update_correspondences(
        x0, src, target, cfg, cap, backend
    )
    j = jnp.clip(corr, 0, None)
    mu_b = target.points[j]
    e = (mu_b - p_t) * weight[..., None]           # [Ns, 3]
    me = jnp.einsum("nij,nj->ni", mahal, e)        # [Ns, 3]
    err = jnp.sum(e * me)
    # J = [ skew(p_t) | -I ]  (3x6). Blocks of H = J^T M J:
    #   H = [[ S^T M S,  -S^T M ], [ -M S,  M ]],  b = [ S^T M e, -M e ]
    s = se3.skew(p_t)                               # [Ns, 3, 3]
    ms = jnp.einsum("nij,njk->nik", mahal, s)       # [Ns, 3, 3] = M S
    stms = jnp.einsum("nji,njk->nik", s, ms)        # S^T (M S)
    stm = jnp.einsum("nji,njk->nik", s, mahal)      # S^T M
    h_tl = jnp.sum(stms, axis=0)
    h_tr = -jnp.sum(stm, axis=0)
    h_br = jnp.sum(mahal, axis=0)
    h = jnp.block([[h_tl, h_tr], [h_tr.T, h_br]])
    b_top = jnp.einsum("nji,nj->i", s, me)
    b_bot = -jnp.sum(me, axis=0)
    b = jnp.concatenate([b_top, b_bot])
    n_corr = jnp.sum(weight).astype(jnp.int32)
    return _Linearization(h=h, b=b, error=err, corr=corr, weight=weight,
                          mu_b=mu_b, n_b=n_b, m0=m0, n_corr=n_corr)


def _compute_error(x0, src: GicpSource, lin: _Linearization):
    """Reference nano_gicp_impl.hpp:272-296 — frozen correspondences.

    Mahalanobis matrices are recomputed columnwise from the frozen normals
    (n_b, m0) instead of being stored: ~15 [Ns]-wide vectors instead of an
    [Ns, 3, 3] array — fully fusable by XLA, one pass over 2 MB instead of
    several over 12 MB. Identical math: M = w * (2I - (1-eps)(n_b n_b^T +
    m0 m0^T))^{-1}, frozen at the linearization's rotation.
    """
    p_t = se3.transform_points(x0, src.points)
    e = lin.mu_b - p_t
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    nx, ny, nz = lin.n_b[:, 0], lin.n_b[:, 1], lin.n_b[:, 2]
    mx, my, mz = lin.m0[:, 0], lin.m0[:, 1], lin.m0[:, 2]
    a = jnp.float32(1.0 - PLANE_EPS)
    a00 = 2.0 - a * (nx * nx + mx * mx)
    a01 = -a * (nx * ny + mx * my)
    a02 = -a * (nx * nz + mx * mz)
    a11 = 2.0 - a * (ny * ny + my * my)
    a12 = -a * (ny * nz + my * mz)
    a22 = 2.0 - a * (nz * nz + mz * mz)
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    inv_det = lin.weight / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    m00 = co00 * inv_det
    m01 = co01 * inv_det
    m02 = co02 * inv_det
    m11 = (a00 * a22 - a02 * a02) * inv_det
    m12 = (a01 * a02 - a00 * a12) * inv_det
    m22 = (a00 * a11 - a01 * a01) * inv_det
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    return jnp.sum(ex * mex + ey * mey + ez * mez)


def _is_converged(delta: jnp.ndarray, cfg: GicpStageConfig) -> jnp.ndarray:
    """Reference lsq_registration_impl.hpp:118-127."""
    r = delta[:3, :3] - jnp.eye(3, dtype=delta.dtype)
    t = delta[:3, 3]
    r_max = jnp.max(jnp.abs(r)) / cfg.rotation_epsilon
    t_max = jnp.max(jnp.abs(t)) / cfg.transformation_epsilon
    return jnp.maximum(r_max, t_max) < 1.0


def _reorthonormalize(x: jnp.ndarray) -> jnp.ndarray:
    """Keep the rotation block orthonormal under f32 compounding (quat roundtrip)."""
    q = se3.rotmat_to_quat(x[:3, :3])
    return se3.make_se3(se3.quat_to_rotmat(q), x[:3, 3])


def _solve6(h: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.solve(h, -b)


@f32_matmuls
def align(
    src: GicpSource,
    target: GicpTarget,
    guess: jnp.ndarray,
    cfg: GicpStageConfig,
    cap: int,
    backend: str = "hashgrid",
) -> GicpResult:
    """Register ``src`` onto ``target`` starting from ``guess`` (4x4).

    Faithful to ``LsqRegistration::computeTransformation``
    (``lsq_registration_impl.hpp:89-115``) with the reference-default LM
    inner step, or plain GN when ``cfg.optimizer == "gn"``.
    ``backend``: "hashgrid" or "brute" (see config.resolve_backend).
    """
    eye6 = jnp.eye(6, dtype=jnp.float32)

    use_lm = cfg.optimizer == "lm"

    def lm_step(x0, lm_lambda):
        """One step_lm (lsq_registration_impl.hpp:161-208).

        Returns (x_new, lambda_new, delta, ok, h).
        """
        lin = _linearize(x0, src, target, cfg, cap, backend)
        y0 = lin.error
        lm_lambda = jnp.where(
            lm_lambda < 0.0,
            cfg.lm_init_lambda_factor * jnp.max(jnp.abs(jnp.diagonal(lin.h))),
            lm_lambda,
        )

        # inner retry loop: i < lm_max_iterations
        def inner_cond(c):
            _, _, _, _, i, done, _ = c
            return (~done) & (i < cfg.lm_max_iterations)

        def inner_body(c):
            x0_in, lam, nu, _, i, _, _ = c
            d = _solve6(lin.h + lam * eye6, lin.b)
            delta = se3.se3_exp(d)
            xi = _reorthonormalize(delta @ x0_in)
            yi = _compute_error(xi, src, lin)
            denom = jnp.dot(d, lam * d - lin.b)
            rho = (y0 - yi) / jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
            accept = rho >= 0.0
            conv_reject = (~accept) & _is_converged(delta, cfg)
            lam_new = jnp.where(
                accept,
                lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                nu * lam,
            )
            nu_new = jnp.where(accept, nu, 2.0 * nu)
            x_new = jnp.where(accept, xi, x0_in)
            done = accept | conv_reject
            ok = accept | conv_reject  # reference returns true in both paths
            return (x_new, lam_new, nu_new, delta, i + 1, done, ok)

        init = (
            x0, lm_lambda, jnp.float32(2.0), jnp.eye(4, dtype=jnp.float32),
            jnp.int32(0), jnp.asarray(False), jnp.asarray(False),
        )
        x_new, lam_new, _, delta, _, _, ok = jax.lax.while_loop(
            inner_cond, inner_body, init
        )
        return x_new, lam_new, delta, ok, lin.h, lin.error, lin.n_corr

    def gn_step(x0, lm_lambda):
        """step_gn (lsq_registration_impl.hpp:142-158)."""
        lin = _linearize(x0, src, target, cfg, cap, backend)
        d = _solve6(lin.h, lin.b)
        delta = se3.se3_exp(d)
        x_new = _reorthonormalize(delta @ x0)
        return (x_new, lm_lambda, delta, jnp.asarray(True), lin.h, lin.error,
                lin.n_corr)

    step = lm_step if use_lm else gn_step

    def outer_cond(c):
        _, _, i, converged, failed, *_ = c
        return (i < cfg.max_iterations) & (~converged) & (~failed)

    def outer_body(c):
        x0, lam, i, _, _, h_prev, err_prev, nc_prev = c
        x_new, lam_new, delta, ok, h, err, n_corr = step(x0, lam)
        converged = ok & _is_converged(delta, cfg)
        failed = ~ok
        x_keep = jnp.where(ok, x_new, x0)
        return (x_keep, lam_new, i + 1, converged, failed, h, err, n_corr)

    x0 = _reorthonormalize(guess.astype(jnp.float32))
    init = (
        x0, jnp.float32(-1.0), jnp.int32(0), jnp.asarray(False), jnp.asarray(False),
        jnp.eye(6, dtype=jnp.float32), jnp.float32(0.0), jnp.int32(0),
    )
    x_fin, _, iters, converged, failed, h_fin, err_fin, nc_fin = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    return GicpResult(
        transform=x_fin,
        hessian=h_fin,
        iterations=iters,
        converged=converged,
        lm_failed=failed,
        final_error=err_fin,
        num_correspondences=nc_fin,
    )
