"""Keyframe spawning logic.

Reference ``updateKeyframes`` (``odom.cc:1097-1181``): distance/rotation to
the closest keyframe with a nearby-count special case; on spawn, the
world-transformed scan is submap-voxelized and stored with its pose and
per-point covariances (normals here).

The reference's decision chain (``odom.cc:1143-1153``) reduces to:
``new = (dd > threshD) or (theta > threshR and num_nearby <= 1)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import DloConfig
from direct_lidar_odometry_tpu.core import se3
from direct_lidar_odometry_tpu.core.cloud import PAD_VALUE, PointCloud
from direct_lidar_odometry_tpu.ops import voxel
from direct_lidar_odometry_tpu.registration import covariance
from direct_lidar_odometry_tpu.odometry.state import KeyframeStore


class KeyframeDecision(NamedTuple):
    spawn: jnp.ndarray        # bool
    closest_dist: jnp.ndarray  # f32
    num_nearby: jnp.ndarray   # int32


def decide(
    kf: KeyframeStore,
    position: jnp.ndarray,
    quat: jnp.ndarray,
    thresh_dist: jnp.ndarray,
    thresh_rot_deg: float,
) -> KeyframeDecision:
    """Reference odom.cc:1104-1153."""
    kmask = jnp.arange(kf.capacity) < kf.count
    d = jnp.linalg.norm(kf.positions - position, axis=-1)
    d = jnp.where(kmask, d, jnp.inf)
    num_nearby = jnp.sum((d <= thresh_dist * 1.5) & kmask).astype(jnp.int32)
    closest = jnp.argmin(d)
    dd = d[closest]
    theta_deg = se3.quat_angle_deg(quat, kf.quats[closest])
    spawn = (dd > thresh_dist) | (
        (theta_deg > thresh_rot_deg) & (num_nearby <= 1)
    )
    # no keyframes yet -> always spawn (cannot happen after init, but safe)
    spawn = jnp.where(kf.count == 0, True, spawn)
    return KeyframeDecision(spawn=spawn, closest_dist=dd, num_nearby=num_nearby)


def make_keyframe_cloud(
    scan: PointCloud, pose: jnp.ndarray, cfg: DloConfig, backend: str = "hashgrid"
) -> tuple[PointCloud, covariance.Normals]:
    """World-transform the scan, submap-voxelize, recompute normals.

    Reference odom.cc:1155-1174 (transformCurrentScan + vf_submap +
    calculateSourceCovariances on the keyframe cloud).
    """
    world_pts = se3.transform_points(pose, scan.points)
    world_pts = jnp.where(scan.mask[..., None], world_pts, PAD_VALUE)
    c = PointCloud(points=world_pts, mask=scan.mask)
    if cfg.preprocessing.voxel_submap.use:
        c = voxel.voxel_downsample(
            c, cfg.preprocessing.voxel_submap.res, out_capacity=cfg.shapes.n_keyframe
        )
    else:
        c = PointCloud(
            points=c.points[: cfg.shapes.n_keyframe],
            mask=c.mask[: cfg.shapes.n_keyframe],
        )
    # NB: the reference computes keyframe covariances through the *s2s* GICP
    # instance (odom.cc:1172-1174), so k here is s2s.k_correspondences (10),
    # not s2m's 20 — s2m's own k is effectively unused upstream because its
    # covariances are always injected externally.
    if backend == "brute":
        nrm = covariance.estimate_normals_brute(
            c.points, c.mask,
            k=cfg.gicp.s2s.k_correspondences,
            chunk=min(cfg.shapes.knn_query_chunk, cfg.shapes.n_keyframe),
        )
    else:
        nrm = covariance.estimate_normals_twoscale(
            c.points, c.mask,
            k=cfg.gicp.s2s.k_correspondences,
            chunk=min(cfg.shapes.knn_query_chunk, cfg.shapes.n_keyframe),
            cap=cfg.shapes.cell_cap_knn,
        )
    return c, nrm


def _eviction_slot(kf: KeyframeStore, position: jnp.ndarray) -> jnp.ndarray:
    """Pick the slot to overwrite when the ring is full: find the densest
    keyframe pair (smallest pairwise distance) and evict the member of that
    pair farther from the incoming position.

    Rationale: the reference grows ``keyframes`` forever (``odom.cc:1166``),
    which static shapes cannot. Evicting the most REDUNDANT keyframe (one of
    the two closest together) keeps both local context and global map
    coverage; evicting by raw farthest-distance would eat the trajectory's
    start and break loop-closure/hull context on return visits.
    """
    k = kf.capacity
    d2 = jnp.sum(
        (kf.positions[:, None, :] - kf.positions[None, :, :]) ** 2, axis=-1
    )
    d2 = d2 + jnp.where(jnp.eye(k, dtype=bool), jnp.inf, 0.0)
    flat = jnp.argmin(d2)
    i, j = flat // k, flat % k
    di = jnp.sum((kf.positions[i] - position) ** 2)
    dj = jnp.sum((kf.positions[j] - position) ** 2)
    return jnp.where(di > dj, i, j).astype(jnp.int32)


def insert(
    kf: KeyframeStore,
    position: jnp.ndarray,
    quat: jnp.ndarray,
    cloud: PointCloud,
    normals: covariance.Normals,
    seq: jnp.ndarray | None = None,
    health: jnp.ndarray | None = None,
) -> tuple[KeyframeStore, jnp.ndarray]:
    """Append at ``count``; at capacity, evict the most redundant keyframe
    (see :func:`_eviction_slot`) instead of silently dropping the new one.

    Returns (store, evicted: bool, slot: int32). The caller must invalidate
    any cached submap when ``evicted`` is true — slot contents changed under
    a possibly-identical membership mask (see pipeline.odom_frame). The slot
    lets host-side mirrors (e.g. the runner's intensity sidecar) track ring
    contents through eviction.
    """
    full = kf.count >= kf.capacity
    idx = jnp.where(full, _eviction_slot(kf, position), kf.count)
    idx = jnp.clip(idx, 0, kf.capacity - 1).astype(jnp.int32)

    def write(arr, val):
        return arr.at[idx].set(val)

    return KeyframeStore(
        positions=write(kf.positions, position),
        quats=write(kf.quats, quat),
        points=write(kf.points, cloud.points),
        masks=write(kf.masks, cloud.mask),
        normals=write(kf.normals, normals.normals),
        normals_valid=write(kf.normals_valid, normals.valid),
        count=jnp.where(full, kf.count, kf.count + 1),
        # monotonic insertion id (empty slots carry -1, so the default
        # first insert gets 0); keeps trajectory order recoverable after
        # eviction rewrites slots — see KeyframeStore.seq. The pipeline
        # passes the SPAWN FRAME INDEX, which additionally gives exact
        # keyframe <-> ground-truth association for evaluation.
        seq=write(kf.seq, jnp.max(kf.seq) + 1 if seq is None
                  else jnp.asarray(seq, jnp.int32)),
        # spawn-frame odometry health (0 = unknown/healthy) — feeds the
        # information-weighted chain prior of the pose-graph refinement
        health=write(kf.health, jnp.float32(0.0) if health is None
                     else jnp.asarray(health, jnp.float32)),
    ), full, idx


def maybe_spawn(
    kf: KeyframeStore,
    scan: PointCloud,
    pose: jnp.ndarray,
    cfg: DloConfig,
    thresh_dist: jnp.ndarray,
    backend: str = "hashgrid",
    seq: jnp.ndarray | None = None,
    health: jnp.ndarray | None = None,
) -> tuple[KeyframeStore, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full updateKeyframes step. Returns (store, spawned, evicted, slot);
    slot is the written ring index, or -1 if no keyframe spawned.
    ``seq``: insertion id recorded for the new keyframe (the pipeline
    passes the frame index — see KeyframeStore.seq). ``health``: spawn
    frame's S2M per-correspondence error (see KeyframeStore.health)."""
    position = se3.se3_translation(pose)
    quat = se3.rotmat_to_quat(se3.se3_rotation(pose))
    dec = decide(kf, position, quat, thresh_dist, cfg.keyframe.thresh_rot)

    def spawn(_):
        cloud, nrm = make_keyframe_cloud(scan, pose, cfg, backend)
        return insert(kf, position, quat, cloud, nrm, seq=seq, health=health)

    def keep(_):
        return kf, jnp.asarray(False), jnp.int32(-1)

    new_kf, evicted, slot = jax.lax.cond(dec.spawn, spawn, keep, None)
    return new_kf, dec.spawn, evicted, slot
