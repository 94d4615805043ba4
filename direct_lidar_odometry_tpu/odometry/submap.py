"""Submap keyframe selection and assembly.

Reference ``getSubmapKeyframes`` (``odom.cc:1240-1331``): the S2M target is
the union of (a) the knn nearest keyframes by pose distance, (b) the kcv
nearest among convex-hull keyframes, (c) the kcc nearest among
concave-hull keyframes — deduplicated, with change detection so the
concatenated submap cloud/normals (and here, its hash grid) are rebuilt
only when the index set changes.

``pushSubmapIndices`` keeps *every* element <= the kth smallest distance
(ties included, ``odom.cc:1210-1233``); the same semantics here via a
top-k threshold instead of a heap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import DloConfig, submap_flat_size
from direct_lidar_odometry_tpu.ops import hashgrid
from direct_lidar_odometry_tpu.odometry import hulls
from direct_lidar_odometry_tpu.odometry.state import KeyframeStore, OdomState


def k_smallest_members(
    d2: jnp.ndarray, mask: jnp.ndarray, k: int
) -> jnp.ndarray:
    """[K], [K] -> [K] bool: elements <= the kth smallest masked distance."""
    big = jnp.asarray(jnp.inf, d2.dtype)
    vals = jnp.where(mask, d2, big)
    kk = min(k, d2.shape[0])
    neg_topk, _ = jax.lax.top_k(-vals, kk)
    kth = -neg_topk[-1]  # kth smallest (inf if fewer than k valid)
    kth = jnp.where(jnp.isfinite(kth), kth, jnp.max(jnp.where(mask, vals, -big), initial=0.0))
    return mask & (vals <= kth)


class SubmapSelection(NamedTuple):
    members: jnp.ndarray  # [K] bool
    changed: jnp.ndarray  # bool


def select_submap_keyframes(
    kf: KeyframeStore,
    prev_members: jnp.ndarray,
    query_pos: jnp.ndarray,
    alpha: jnp.ndarray,
    cfg: DloConfig,
    directions: jnp.ndarray,
    hull_masks: tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
) -> SubmapSelection:
    """Choose the submap keyframe set for the current S2S pose estimate.

    ``query_pos`` is the S2S-propagated position (reference uses
    ``T_s2s`` translation, ``odom.cc:1248``).

    ``hull_masks`` = (cvx [K] bool, ccv [K] bool, fresh scalar bool):
    exact QHull memberships computed on the host one frame behind
    (odometry/hosthull.py). When provided and fresh, they replace the
    device direction-sampled surrogates — exact reference semantics
    (``odom.cc:1017-1090``); when stale/absent the surrogate keeps the
    step fully device-resident (batched/sharded paths, first frames).
    """
    k = kf.capacity
    kmask = jnp.arange(k) < kf.count
    diff = kf.positions - query_pos
    d2 = jnp.sum(diff * diff, axis=-1)

    knn_sel = k_smallest_members(d2, kmask, cfg.submap.knn)

    cvx = hulls.convex_membership(kf.positions, kmask, directions)
    ccv = hulls.concave_membership(kf.positions, kmask, directions, alpha)
    if hull_masks is not None:
        h_cvx, h_ccv, fresh = hull_masks
        cvx = jnp.where(fresh, h_cvx & kmask, cvx)
        ccv = jnp.where(fresh, h_ccv & kmask, ccv)
    cvx_sel = k_smallest_members(d2, cvx, cfg.submap.kcv)
    ccv_sel = k_smallest_members(d2, ccv, cfg.submap.kcc)

    members = (knn_sel | cvx_sel | ccv_sel) & kmask
    # cap at max_submap_kf members, keeping the NEAREST (the reference set
    # is <= knn+kcv+kcc = 30 pre-dedup so overflow is rare, but when it
    # happens the distant hull-context members are the right ones to cut —
    # never the nearby keyframes the scan actually overlaps)
    members = k_smallest_members(d2, members, cfg.shapes.max_submap_kf)
    # k_smallest keeps <= kth value, so exact distance ties can overflow
    # the cap; enforce the hard bound the slot packing needs
    idx_rank = jnp.cumsum(members.astype(jnp.int32)) - 1
    members = members & (idx_rank < cfg.shapes.max_submap_kf)
    changed = jnp.any(members != prev_members)
    return SubmapSelection(members=members, changed=changed)


def assemble_submap(
    state: OdomState,
    sel: SubmapSelection,
    query_pos: jnp.ndarray,
    cfg: DloConfig,
    backend: str,
) -> OdomState:
    """Rebuild the flattened submap cloud + normals (+ hash grid) iff changed.

    Reference ``odom.cc:1309-1329`` (concatenate keyframe clouds and cached
    normals) plus the index build the reference hides inside
    ``gicp.setInputTarget`` (``odom.cc:828``). When the concatenation
    exceeds ``shapes.n_submap_flat``, the points nearest ``query_pos`` are
    kept (distant submap points cannot match a range-bounded scan anyway).
    """
    s_max = cfg.shapes.max_submap_kf
    nk = cfg.shapes.n_keyframe
    flat_out = submap_flat_size(cfg)
    kf = state.keyframes
    k = kf.capacity

    def rebuild(_):
        # pack member keyframe indices (ascending) into s_max slots
        order_key = jnp.where(sel.members, jnp.arange(k), k + jnp.arange(k))
        order = jnp.argsort(order_key)[:s_max]  # first s_max = members first
        slot_valid = sel.members[order]  # [S]
        pts = kf.points[order].reshape(s_max * nk, 3)
        msk = (kf.masks[order] & slot_valid[:, None]).reshape(s_max * nk)
        nrm = kf.normals[order].reshape(s_max * nk, 3)
        nvl = (kf.normals_valid[order] & slot_valid[:, None]).reshape(s_max * nk)
        if flat_out < s_max * nk:
            d2 = jnp.sum((pts - query_pos) ** 2, axis=-1)
            d2 = jnp.where(msk, d2, jnp.inf)
            keep_order = jnp.argsort(d2)[:flat_out]
            pts, msk = pts[keep_order], msk[keep_order]
            nrm, nvl = nrm[keep_order], nvl[keep_order]
        grid = (
            hashgrid.build(
                pts, msk,
                cfg.gicp.s2m.max_correspondence_distance,
                cfg.shapes.submap_table_size,
            )
            if backend == "hashgrid"
            else None
        )
        return pts, msk, nrm, nvl, grid

    def keep(_):
        return (
            state.submap_points,
            state.submap_mask,
            state.submap_normals,
            state.submap_normals_valid,
            state.submap_grid,
        )

    pts, msk, nrm, nvl, grid = jax.lax.cond(sel.changed, rebuild, keep, None)
    return state._replace(
        submap_members=sel.members,
        submap_points=pts,
        submap_mask=msk,
        submap_normals=nrm,
        submap_normals_valid=nvl,
        submap_grid=grid,
    )
