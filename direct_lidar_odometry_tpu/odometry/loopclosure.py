"""Loop closure + map refinement — a capability the reference lacks.

The reference never revisits its keyframes: drift accumulates unbounded
over long trajectories (SURVEY.md §5 "no relocalization, no divergence
detection"). This module closes the loop:

1. **Candidate detection** (:func:`loop_candidates`): keyframe pairs whose
   pose distance is small but whose insertion indices are far apart — the
   robot came back. Pure masked top-k over the [K, K] pose-distance
   matrix; K <= 512 so the whole thing is one tiny fused XLA reduction.
2. **Constraint measurement** (:func:`register_loop_edges`): GICP between
   the stored world-frame keyframe clouds (normals are already cached in
   the ring, ``odom.cc:1324`` role) under an identity guess — the clouds
   are within drift distance of each other by construction. The measured
   relative pose is ``Z_ij = X_i^-1 dT X_j`` where ``dT`` aligns cloud j
   onto cloud i. Edges that fail to converge or match too few points are
   weight-zeroed, never deleted (static shapes).
3. **Refinement** (:func:`refine_and_reanchor`): chain edges from the
   current estimates (the odometry prior) + measured loop edges feed the
   dense SE(3) Gauss-Newton of parallel/posegraph.py; every keyframe
   cloud, its cached normals, the current pose, and the S2S propagation
   basis are re-anchored by the per-keyframe correction, and the cached
   submap is invalidated so the next frame rebuilds it from the refined
   ring.

Everything here is jit-compatible (static shapes, masked edges) and runs
off the per-frame hot path — the runner triggers it every
``posegraph.refine_every_kf`` keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import DloConfig
from direct_lidar_odometry_tpu.core import se3
from direct_lidar_odometry_tpu.odometry.state import KeyframeStore, OdomState
from direct_lidar_odometry_tpu.parallel import posegraph
from direct_lidar_odometry_tpu.registration import gicp


class LoopEdges(NamedTuple):
    edges: jnp.ndarray    # [L, 2] int32 (i, j), i < j
    mask: jnp.ndarray     # [L] bool candidate validity
    rel: jnp.ndarray      # [L, 4, 4] measured Z_ij (identity when invalid)
    weight: jnp.ndarray   # [L] information weight (0 when rejected)
    num_corr: jnp.ndarray  # [L] int32 GICP correspondences (diagnostics)


class RefineInfo(NamedTuple):
    """Host-readable refinement diagnostics."""

    n_candidates: jnp.ndarray  # int32 loop candidates found
    n_accepted: jnp.ndarray    # int32 loop edges that passed the GICP gate
    graph_error: jnp.ndarray   # f32 final graph residual
    max_correction: jnp.ndarray  # f32 largest keyframe translation correction


def loop_candidates(
    store: KeyframeStore, loop_radius: float, min_index_gap: int,
    max_loops: int, min_seq_gap: int = 0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-``max_loops`` closest eligible (i, j) keyframe pairs.

    Eligibility: both slots occupied, insertion-RANK separation >=
    ``min_index_gap`` (ranks come from ``KeyframeStore.seq`` so
    eviction-rewritten slots cannot fake a gap), optional spawn-FRAME
    separation >= ``min_seq_gap``, pose distance < loop_radius. Returns
    ([L, 2] int32 edges, [L] bool mask). Selection is k-smallest by
    distance — redundant neighbors of the same revisit are harmless to
    GN (they just over-weight that closure slightly).

    NOTE on units (round-4 advisor): ``min_index_gap`` counts SURVIVING
    keyframes — after heavy eviction two keyframes many frames apart can
    sit at a small rank gap and be excluded. For long evicting runs set
    ``min_seq_gap`` (frame units, eviction-invariant) instead of
    rescaling min_index_gap.
    """
    k = store.capacity
    pos = store.positions
    valid = jnp.arange(k) < store.count
    # rank of each slot in trajectory (insertion) order
    order = jnp.argsort(jnp.where(valid, store.seq, jnp.int32(2 ** 30)))
    rank = jnp.zeros((k,), jnp.int32).at[order].set(
        jnp.arange(k, dtype=jnp.int32)
    )
    d = jnp.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)  # [K, K]
    gap = jnp.abs(rank[None, :] - rank[:, None])
    seq_gap = jnp.abs(store.seq[None, :] - store.seq[:, None])
    # keep i = the EARLIER keyframe of the pair (rank order), j = later
    later = rank[None, :] > rank[:, None]
    ok = (
        valid[:, None] & valid[None, :]
        & later
        & (gap >= min_index_gap)
        & (seq_gap >= min_seq_gap)
        & (d < loop_radius)
    )
    flat_d = jnp.where(ok, d, jnp.inf).reshape(-1)
    _, idx = jax.lax.top_k(-flat_d, max_loops)
    e_i = (idx // k).astype(jnp.int32)
    e_j = (idx % k).astype(jnp.int32)
    mask = jnp.isfinite(flat_d[idx])
    return jnp.stack([e_i, e_j], axis=1), mask


def register_loop_edges(
    store: KeyframeStore, edges: jnp.ndarray, mask: jnp.ndarray,
    cfg: DloConfig, backend: str,
) -> LoopEdges:
    """Measure loop constraints by cloud-to-cloud GICP.

    Keyframe clouds are stored in the WORLD frame (state.py KeyframeStore),
    so aligning cloud j (source) onto cloud i (target) from an identity
    guess yields the world-frame drift correction ``dT``; the measured
    relative pose is ``Z_ij = X_i^-1 dT X_j``. Registration params are the
    S2M stage (same clouds, same density) but with the WIDE loop gate: the
    identity guess must swallow the accumulated drift between the two
    visits, so the correspondence distance is ``posegraph.loop_corr_distance``
    (2.0 m default) rather than S2M's tightly-guessed 0.5 m — under the
    tight gate any revisit with >0.5 m drift finds few/no correspondences
    and the edge is weight-zeroed exactly when loop closure is needed.
    ``loop_max_iterations`` likewise extends the iteration budget for the
    longer pull. ``lax.map`` keeps one GICP problem in flight at a time —
    loop edges are few and off the hot path, so a small working set beats
    parallelism here.
    """
    import dataclasses as _dc

    eye = jnp.eye(4, dtype=jnp.float32)
    stage = _dc.replace(
        cfg.gicp.s2m,
        max_correspondence_distance=cfg.posegraph.loop_corr_distance,
        max_iterations=cfg.posegraph.loop_max_iterations,
    )

    def one(args):
        e, m = args
        i, j = e[0], e[1]
        target = gicp.make_target(
            store.points[i], store.masks[i] & m,
            store.normals[i], store.normals_valid[i],
            stage.max_correspondence_distance,
            cfg.shapes.submap_table_size, backend=backend,
        )
        src = gicp.GicpSource(
            points=store.points[j], mask=store.masks[j] & m,
            normals=store.normals[j], normals_valid=store.normals_valid[j],
        )
        res = gicp.align(src, target, eye, stage,
                         cap=cfg.shapes.cell_cap_1nn, backend=backend)
        x_i = se3.make_se3(se3.quat_to_rotmat(store.quats[i]),
                           store.positions[i])
        x_j = se3.make_se3(se3.quat_to_rotmat(store.quats[j]),
                           store.positions[j])
        z = se3.se3_inverse(x_i) @ (res.transform @ x_j)
        good = (
            m & res.converged & ~res.lm_failed
            & (res.num_correspondences >= cfg.posegraph.min_loop_corr)
        )
        w = jnp.where(good, jnp.float32(cfg.posegraph.loop_weight), 0.0)
        z = jnp.where(good, z, eye)
        return z, w, res.num_correspondences

    rel, weight, num_corr = jax.lax.map(one, (edges, mask))
    return LoopEdges(edges=edges, mask=mask, rel=rel, weight=weight,
                     num_corr=num_corr)


def build_refinement_graph(
    store: KeyframeStore, loops: LoopEdges, chain_weight: float,
) -> posegraph.PoseGraph:
    """Chain prior (current estimates) + measured loop edges, static shape.

    Chain edges start at zero residual — they are the odometry prior that
    anchors the solution; loop edges carry the new information and GN
    redistributes their correction along the chain (the adjoint-coupled
    Jacobians in posegraph.py are what make that redistribution correct).

    Chain edges are INFORMATION-WEIGHTED by the endpoints' spawn-time
    odometry health (KeyframeStore.health): an edge whose odometry ran
    through a degraded stretch gets weight scaled by (median_health /
    edge_health)^2, so the loop correction concentrates where the drift
    actually arose. With uniform weights the solver spreads the
    correction evenly around the trajectory, dragging accurate keyframes
    off ground truth while fixing drifted ones (measured: mean keyframe
    map error 0.084 -> 0.199 m on a burst-drift run; the weighted prior
    is what makes the same closure repair it).
    """
    chain = posegraph.odometry_chain_graph(
        store.positions, store.quats, store.count, seq=store.seq
    )
    k = store.capacity
    valid = jnp.arange(k) < store.count
    # median spawn health over valid keyframes = the "healthy" reference
    h_sorted = jnp.sort(jnp.where(valid, store.health, jnp.inf))
    med = h_sorted[jnp.maximum(store.count - 1, 0) // 2]
    med = jnp.maximum(med, 1e-6)
    h_edge = jnp.maximum(store.health[chain.edges[:, 0]],
                         store.health[chain.edges[:, 1]])
    info = (med / jnp.maximum(h_edge, med)) ** 2  # in (0, 1], 1 = healthy
    return posegraph.PoseGraph(
        poses=chain.poses,
        pose_mask=chain.pose_mask,
        edges=jnp.concatenate([chain.edges, loops.edges], axis=0),
        rel=jnp.concatenate([chain.rel, loops.rel], axis=0),
        edge_mask=jnp.concatenate(
            [chain.edge_mask, loops.weight > 0], axis=0
        ),
        weights=jnp.concatenate(
            [chain.weights * chain_weight * info, loops.weight], axis=0
        ),
    )


def reanchor(
    state: OdomState, new_poses: jnp.ndarray
) -> tuple[OdomState, jnp.ndarray]:
    """Apply refined keyframe poses to every world-frame artifact.

    Per-keyframe correction ``dT_k = X_k_new X_k_old^-1`` re-transforms the
    stored clouds and rotates the cached normals; the current pose and the
    S2S propagation basis are re-anchored by the correction of the
    keyframe nearest the current position (the local frame the robot is
    actually tracking in). The previous scan (S2S target) lives in the
    sensor frame and is untouched. The cached submap is invalidated —
    members cleared — so the next frame rebuilds it from the refined ring
    (same mechanism keyframe eviction uses, pipeline.py).
    """
    store = state.keyframes
    k = store.capacity
    valid = jnp.arange(k) < store.count

    old = jax.vmap(
        lambda p, q: se3.make_se3(se3.quat_to_rotmat(q), p)
    )(store.positions, store.quats)
    delta = jax.vmap(lambda n, o: n @ se3.se3_inverse(o))(new_poses, old)
    # freeze invalid slots (their contents are padding)
    eye = jnp.eye(4, dtype=jnp.float32)
    delta = jnp.where(valid[:, None, None], delta, eye)

    r = delta[:, :3, :3]
    t = delta[:, :3, 3]
    pts = jnp.einsum("kab,knb->kna", r, store.points) + t[:, None, :]
    nrm = jnp.einsum("kab,knb->kna", r, store.normals)
    new_pos = jnp.where(valid[:, None], new_poses[:, :3, 3], store.positions)
    new_quat = jnp.where(
        valid[:, None],
        jax.vmap(lambda p: se3.rotmat_to_quat(p[:3, :3]))(new_poses),
        store.quats,
    )
    new_store = store._replace(
        positions=new_pos, quats=new_quat, points=pts, normals=nrm
    )

    cur = se3.se3_translation(state.pose)
    d2 = jnp.sum((store.positions - cur) ** 2, axis=-1)
    nearest = jnp.argmin(jnp.where(valid, d2, jnp.inf))
    d_anchor = delta[nearest]
    max_corr = jnp.max(
        jnp.where(valid, jnp.linalg.norm(t, axis=-1), 0.0)
    )
    new_state = state._replace(
        keyframes=new_store,
        pose=d_anchor @ state.pose,
        t_s2s=d_anchor @ state.t_s2s,
        submap_members=jnp.zeros_like(state.submap_members),
    )
    return new_state, max_corr


def refine_and_reanchor(
    state: OdomState, cfg: DloConfig, backend: str,
) -> tuple[OdomState, RefineInfo]:
    """Full loop-closure round: detect -> register -> refine -> re-anchor.

    Jit this once per (cfg, backend); it is shape-static. When no loop
    candidate passes the GICP gate the refinement is a no-op by
    construction (chain edges alone have zero residual at the current
    estimates), so calling it speculatively is safe — just not free.
    """
    pg = cfg.posegraph
    edges, cand_mask = loop_candidates(
        state.keyframes, pg.loop_radius, pg.min_index_gap, pg.max_loops,
        min_seq_gap=pg.min_seq_gap,
    )
    loops = register_loop_edges(state.keyframes, edges, cand_mask, cfg, backend)
    graph = build_refinement_graph(state.keyframes, loops, pg.chain_weight)
    n_accepted = jnp.sum((loops.weight > 0).astype(jnp.int32))

    def do_refine(st):
        new_poses, err = posegraph.refine(graph, iterations=pg.iterations)
        st2, max_corr = reanchor(st, new_poses)
        return st2, err, max_corr

    def skip(st):
        return st, jnp.float32(0.0), jnp.float32(0.0)

    state, err, max_corr = jax.lax.cond(n_accepted > 0, do_refine, skip, state)
    info = RefineInfo(
        n_candidates=jnp.sum(cand_mask.astype(jnp.int32)),
        n_accepted=n_accepted,
        graph_error=err,
        max_correction=max_corr,
    )
    return state, info
