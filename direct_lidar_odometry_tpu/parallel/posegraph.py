"""Keyframe pose-graph refinement — dense Gauss-Newton on SE(3)^K.

A capability the reference does not have (SURVEY.md §5: no loop closure,
no global refinement): periodically refine the keyframe poses given
relative-pose constraints (odometry chains and any loop-closure matches),
which re-anchors the map for long trajectories.

Design choices:
- residuals ``e_ij = log(Z_ij^-1 X_i^-1 X_j)`` batched over constraints
  (vmap over [M]), with ANALYTIC first-order Jacobians of the same
  pseudo-exponential retraction the GICP solver uses
  (``core/se3.se3_exp``: rotation via Rodrigues, translation applied
  directly). Right-perturbing ``X_j <- X_j P(xi)`` gives
  ``J_j = [[Jr^-1(w), 0], [0, R_E]]`` and perturbing ``X_i`` gives
  ``J_i = [[-Jr^-1(w) R_A^T, 0], [R_Z^T skew(t_A), -R_Z^T]]`` with
  ``A = X_i^-1 X_j``, ``E = Z^-1 A``, ``w = log(R_E)`` — the
  rotation/translation coupling block ``R_Z^T skew(t_A)`` is what makes
  a loop-closure rotation correction redistribute translation drift
  along the chain. ``Jr^-1(w) ~ I + skew(w)/2`` (first-order right
  Jacobian inverse — standard for PGO, iterated to convergence).
  Analytic rather than jacfwd because ``so3_log``'s arccos has an
  unbounded derivative at zero residual (every chain edge starts there);
- the normal system is assembled DENSE: H is [6K, 6K]. For K <= 1024
  that is a 6144^2 matrix: one dense factorization instead of a
  sparse-scatter pipeline (its cost on the GPU is in PERF.md);
- gauge freedom fixed by pinning pose 0 with a strong prior;
- the distributed form shards the *constraint set* across devices, psums
  the per-shard H/b contributions over the mesh, and solves replicated —
  the Schur-type reduction pattern from BASELINE.json's north star.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.core import se3
from direct_lidar_odometry_tpu.utils.precision import f32_matmuls


class PoseGraph(NamedTuple):
    poses: jnp.ndarray       # [K, 4, 4] current estimates
    pose_mask: jnp.ndarray   # [K] valid poses
    edges: jnp.ndarray       # [M, 2] int32 (i, j)
    rel: jnp.ndarray         # [M, 4, 4] measured Z_ij (i -> j)
    edge_mask: jnp.ndarray   # [M]
    weights: jnp.ndarray     # [M] scalar information weight


def residual(poses: jnp.ndarray, edge, z) -> jnp.ndarray:
    """6-vector [rot, trans] residual of one edge."""
    i, j = edge[0], edge[1]
    t_ij = se3.se3_inverse(poses[i]) @ poses[j]
    err = se3.se3_inverse(z) @ t_ij
    w = se3.so3_log(err[:3, :3])
    return jnp.concatenate([w, err[:3, 3]])


def edge_jacobians(x_i, x_j, z):
    """Residual + exact first-order Jacobians wrt right perturbations.

    Retraction: ``X <- X P(xi)``, ``P(xi) = (so3_exp(xi_w), xi_t)`` — the
    same pseudo-exp the whole framework optimizes over (se3.se3_exp).
    Derivation in the module docstring. Returns (r [6], J_i [6,6],
    J_j [6,6]).
    """
    a = se3.se3_inverse(x_i) @ x_j          # A = X_i^-1 X_j
    err = se3.se3_inverse(z) @ a            # E = Z^-1 A
    r_e = err[:3, :3]
    w = se3.so3_log(r_e)
    r = jnp.concatenate([w, err[:3, 3]])

    jr_inv = jnp.eye(3, dtype=jnp.float32) + 0.5 * se3.skew(w)
    r_a = a[:3, :3]
    r_zt = z[:3, :3].T
    zero = jnp.zeros((3, 3), jnp.float32)
    j_j = jnp.block([[jr_inv, zero], [zero, r_e]])
    j_i = jnp.block(
        [[-jr_inv @ r_a.T, zero], [r_zt @ se3.skew(a[:3, 3]), -r_zt]]
    )
    return r, j_i, j_j


def _edge_terms(poses, edge, z, w):
    """Per-edge Gauss-Newton H-blocks and b-segments."""
    r, j_i, j_j = edge_jacobians(poses[edge[0]], poses[edge[1]], z)
    h_ii = w * (j_i.T @ j_i)
    h_jj = w * (j_j.T @ j_j)
    h_ij = w * (j_i.T @ j_j)
    b_i = w * (j_i.T @ r)
    b_j = w * (j_j.T @ r)
    return r, h_ii, h_jj, h_ij, b_i, b_j


def build_normal_system(graph: PoseGraph) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assemble dense H [6K, 6K], b [6K] over (possibly a shard of) edges."""
    k = graph.poses.shape[0]
    w = graph.weights * graph.edge_mask.astype(jnp.float32)
    r, h_ii, h_jj, h_ij, b_i, b_j = jax.vmap(
        lambda e, z, wi: _edge_terms(graph.poses, e, z, wi)
    )(graph.edges, graph.rel, w)

    h = jnp.zeros((k, k, 6, 6), jnp.float32)
    i_idx = graph.edges[:, 0]
    j_idx = graph.edges[:, 1]
    h = h.at[i_idx, i_idx].add(h_ii)
    h = h.at[j_idx, j_idx].add(h_jj)
    h = h.at[i_idx, j_idx].add(h_ij)
    h = h.at[j_idx, i_idx].add(jnp.swapaxes(h_ij, -1, -2))
    b = jnp.zeros((k, 6), jnp.float32)
    b = b.at[i_idx].add(b_i)
    b = b.at[j_idx].add(b_j)
    err = jnp.sum(w * jnp.sum(r * r, axis=-1))
    h = h.transpose(0, 2, 1, 3).reshape(k * 6, k * 6)
    return h, b.reshape(k * 6), err


def apply_update(poses: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Right-multiplicative update X_i <- X_i exp(d_i). [K,4,4], [K,6]."""
    def upd(x, d):
        return x @ se3.se3_exp(d)

    return jax.vmap(upd)(poses, delta.reshape(-1, 6))


@f32_matmuls
def refine(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-4,
    prior_weight: float = 1e6,
    axis_name: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton refinement; returns (poses, final error).

    With ``axis_name`` set (inside shard_map/pmap), each device holds a
    shard of the edges; H/b are psum-reduced over the mesh before the
    replicated dense solve — the distributed Schur-style reduction.
    """
    k = graph.poses.shape[0]
    pin = jnp.zeros((k * 6,), jnp.float32).at[:6].set(prior_weight)
    pose_active = jnp.repeat(graph.pose_mask, 6).astype(jnp.float32)

    def body(_, carry):
        poses, _err = carry
        h, b, err = build_normal_system(graph._replace(poses=poses))
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
            b = jax.lax.psum(b, axis_name)
            err = jax.lax.psum(err, axis_name)
        # gauge prior on pose 0 + damping + freeze invalid poses
        diag = damping + pin + jnp.where(pose_active > 0, 0.0, 1e9)
        h = h + jnp.diag(diag)
        # Jacobi (symmetric diagonal) preconditioning before the f32
        # solve: the raw system spans the 1e6 gauge pin to the 1e-4
        # damping floor (~10 orders), and an unequilibrated f32
        # linalg.solve returns steps with enough error that GN SLIDES —
        # measured on a 100-keyframe loop graph: graph error plateaus
        # while poses walk 0.3->0.5 m away from ground truth with more
        # iterations. Equilibrated, the same graph converges and repairs.
        s = jax.lax.rsqrt(jnp.maximum(jnp.diagonal(h), 1e-12))
        hs = h * s[:, None] * s[None, :]
        delta = jnp.linalg.solve(hs, -(b * s)) * s  # descend the gradient
        delta = delta * pose_active
        return apply_update(poses, delta), err

    poses, err = jax.lax.fori_loop(
        0, iterations, body, (graph.poses, jnp.float32(0.0))
    )
    return poses, err


def odometry_chain_graph(
    positions: jnp.ndarray,
    quats: jnp.ndarray,
    count: jnp.ndarray,
    max_edges: int | None = None,
    seq: jnp.ndarray | None = None,
) -> PoseGraph:
    """Build a chain pose graph from a keyframe store's poses.

    Consecutive keyframes get a relative constraint from the current
    estimates (identity-residual start; becomes informative once loop
    edges or updated measurements are added).

    ``seq``: per-slot insertion sequence numbers (KeyframeStore.seq).
    When given, the chain connects keyframes consecutive in TRAJECTORY
    order — after ring eviction rewrites slots, slot order no longer is
    trajectory order, and a slot-order chain mis-routes loop corrections
    (measured: doubled keyframe map error on an evicting 300-frame run).
    """
    k = positions.shape[0]
    m = max_edges or (k - 1)
    poses = jax.vmap(lambda p, q: se3.make_se3(se3.quat_to_rotmat(q), p))(
        positions, quats
    )
    valid = jnp.arange(k) < count
    if seq is not None:
        # slots sorted by insertion id, invalid slots last
        order = jnp.argsort(jnp.where(valid, seq, jnp.int32(2 ** 30))).astype(
            jnp.int32
        )
    else:
        order = jnp.arange(k, dtype=jnp.int32)
    idx = jnp.arange(m, dtype=jnp.int32)
    r0 = jnp.clip(idx, 0, k - 1)
    r1 = jnp.clip(idx + 1, 0, k - 1)
    edges = jnp.stack([order[r0], order[r1]], axis=1)
    edge_mask = (idx + 1) < count
    rel = jax.vmap(lambda e: se3.se3_inverse(poses[e[0]]) @ poses[e[1]])(edges)
    return PoseGraph(
        poses=poses,
        pose_mask=valid,
        edges=edges,
        rel=rel,
        edge_mask=edge_mask,
        weights=jnp.ones((m,), jnp.float32),
    )
