"""Voxel-grid centroid downsampling as a sort/segment-mean kernel.

Replaces ``pcl::VoxelGrid`` (reference ``odom.cc:126-127, 459-463``;
``map.cc:100-105``) with a fixed-shape sort/scatter pipeline:

1. quantize points to integer voxel coords relative to the cloud min corner;
2. linearize to a collision-free int32 id (grid extents clamped to 1024^3
   cells, i.e. 256 m at 0.25 m resolution — beyond-extent points are capped
   into edge cells, matching PCL's bounded-bbox behavior closely enough);
3. sort by scrambled (bijectively hashed) id — ONE radix sort groups
   equal ids and randomizes group order for uniform overflow;
4. mark segment starts, compact segment slots by prefix-sum, and
   scatter-add points into per-voxel accumulators;
5. centroid = sum / count, emitted compacted-to-front.

Output order is voxel-id order (ascending), which also matches PCL's
leaf-iteration order, so oracle comparisons can sort both sides identically.
"""

from __future__ import annotations

import jax.numpy as jnp

from direct_lidar_odometry_tpu.core.cloud import PAD_VALUE, PointCloud

_GRID_DIM = 1024  # cells per axis; 1024^3 < 2^31 keeps linear ids in int32
_INVALID_CODE = 0xFFFFFFFF  # valid Morton codes use 30 bits (< 0x40000000)


def voxel_ids(points: jnp.ndarray, mask: jnp.ndarray, res: float) -> jnp.ndarray:
    """Collision-free linear voxel id per point; invalid points get INT32_MAX."""
    # min corner over valid points only
    big = jnp.asarray(PAD_VALUE, points.dtype)
    masked = jnp.where(mask[..., None], points, big)
    origin = jnp.min(masked, axis=-2, keepdims=True)
    coords = jnp.floor((points - origin) / res).astype(jnp.int32)
    coords = jnp.clip(coords, 0, _GRID_DIM - 1)
    ids = coords[..., 0] + _GRID_DIM * (coords[..., 1] + _GRID_DIM * coords[..., 2])
    return jnp.where(mask, ids, jnp.iinfo(jnp.int32).max)


def _scramble(ids: jnp.ndarray) -> jnp.ndarray:
    """Murmur-style bijective mix of voxel ids (uint32 order)."""
    h = ids.astype(jnp.uint32)
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def voxel_downsample_morton(
    cloud: PointCloud, res: float, out_capacity: int | None = None
) -> PointCloud:
    """Centroid voxel filter emitting the output in Z (Morton) order.

    The device-side reference of the host preprocessor
    (``io/hostprep.preprocess_morton``, ``cpp/dlo_host.cpp``), which the
    runner uses under ``host_preprocess``. One sort does both jobs: the
    sort key is the Morton code of the integer voxel coordinates, which is
    *bijective* with the voxel id (equal codes <=> equal voxels, so the
    sort groups voxels exactly like :func:`voxel_downsample`) while
    Z-ordering the surviving centroids at voxel-res granularity. Validity
    rides in the key (invalid points carry ``_INVALID_CODE``, above every
    valid 30-bit code).

    Capacity overflow keeps a *spatially uniform* subset, like the
    scrambled-id ordering of :func:`voxel_downsample` but deterministic:
    segments are Bresenham-subsampled along the Z-curve
    (``slot = floor(seg * cap / S)``, keep iff the floor increments),
    and an even stride along a space-filling curve is an even stride
    through space.
    """
    import jax

    from direct_lidar_odometry_tpu.ops import morton

    n = cloud.capacity
    cap = out_capacity or n
    # Bresenham products stay in uint32 (max segment index is n - 1)
    assert (n - 1) * cap < 2 ** 32, (n, cap)
    big = jnp.asarray(PAD_VALUE, cloud.points.dtype)
    masked = jnp.where(cloud.mask[..., None], cloud.points, big)
    origin = jnp.min(masked, axis=-2, keepdims=True)
    coords = jnp.floor((cloud.points - origin) / res).astype(jnp.int32)
    cu = jnp.clip(coords, 0, _GRID_DIM - 1).astype(jnp.uint32)
    code = (
        morton._part_bits(cu[..., 0])
        | (morton._part_bits(cu[..., 1]) << 1)
        | (morton._part_bits(cu[..., 2]) << 2)
    )
    code = jnp.where(cloud.mask, code, jnp.uint32(_INVALID_CODE))

    scode, sx, sy, sz = jax.lax.sort(
        (code, cloud.points[..., 0], cloud.points[..., 1], cloud.points[..., 2]),
        num_keys=1,
    )
    svalid = scode != jnp.uint32(_INVALID_CODE)
    first = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), scode[1:] != scode[:-1]], axis=0
    ) & svalid
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    s_total = jnp.maximum(jnp.sum(first.astype(jnp.int32)), 1)

    # Bresenham stride over Z-ordered segments when S > cap: kept segments
    # get strictly increasing slots in [0, cap); dropped ones go to `cap`
    # (discarded by the scatter's drop mode, like invalid points).
    prod = seg.astype(jnp.uint32) * jnp.uint32(cap)
    su = s_total.astype(jnp.uint32)
    kept = (prod % su) < jnp.uint32(cap)
    slot_over = (prod // su).astype(jnp.int32)
    slot = jnp.where(s_total > cap, jnp.where(kept, slot_over, cap), seg)
    slot = jnp.where(svalid, slot, cap)

    spts = jnp.stack([sx, sy, sz], axis=-1)
    sums = jnp.zeros((cap, 3), dtype=jnp.float32).at[slot].add(
        spts, mode="drop"
    )
    counts = jnp.zeros((cap,), dtype=jnp.float32).at[slot].add(
        jnp.ones((n,), jnp.float32), mode="drop"
    )
    out_mask = counts > 0
    centroids = sums / jnp.maximum(counts, 1.0)[..., None]
    centroids = jnp.where(out_mask[..., None], centroids, PAD_VALUE)
    return PointCloud(points=centroids, mask=out_mask)


def voxel_downsample(
    cloud: PointCloud, res: float, out_capacity: int | None = None
) -> PointCloud:
    """Centroid voxel filter. Output is compacted to the front.

    ``out_capacity`` defaults to the input capacity. If more voxels are
    occupied than ``out_capacity``, a *spatially uniform* subset of voxels
    survives: segments are ordered by a scrambled (hashed) voxel id, so
    overflow degrades into uniform random downsampling. (Ordering by raw
    id instead would keep one bounding-box corner of the scene and drop
    the rest — observed to bias registration by meters.) Output order is
    scrambled-id order.
    """
    import jax

    n = cloud.capacity
    cap = out_capacity or n
    ids = voxel_ids(cloud.points, cloud.mask, res)
    # ONE sort suffices: _scramble is bijective, so equal ids share a key
    # (stay adjacent) and distinct ids get distinct keys — sorting by the
    # scrambled key alone both groups voxels and randomizes group order.
    # Invalid points all carry the INT32_MAX sentinel id, i.e. one shared
    # key; they land somewhere in the middle as a single block and are
    # dropped by the svalid gating below without consuming a segment slot.
    # Coordinates ride along as sort payloads: one multi-operand sort
    # instead of argsort + three 131k-point gathers.
    skey = _scramble(ids)
    _, sids, sx, sy, sz, sv = jax.lax.sort(
        (skey, ids, cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2],
         cloud.mask.astype(jnp.float32)),
        num_keys=1,
    )
    spts = jnp.stack([sx, sy, sz], axis=-1)
    svalid = sv > 0.5

    first = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), sids[1:] != sids[:-1]], axis=0
    ) & svalid
    slot = jnp.cumsum(first.astype(jnp.int32)) - 1  # segment index per point
    slot = jnp.where(svalid, slot, cap)  # out-of-range -> dropped by scatter

    sums = jnp.zeros((cap, 3), dtype=jnp.float32).at[slot].add(
        spts, mode="drop"
    )
    counts = jnp.zeros((cap,), dtype=jnp.float32).at[slot].add(
        jnp.ones((n,), jnp.float32), mode="drop"
    )
    out_mask = counts > 0
    centroids = sums / jnp.maximum(counts, 1.0)[..., None]
    centroids = jnp.where(out_mask[..., None], centroids, PAD_VALUE)
    return PointCloud(points=centroids, mask=out_mask)
