"""Spatial hash-grid neighbor search — the array-program replacement for the kd-tree.

The reference vendors nanoflann's branch-and-bound kd-tree
(``include/nano_gicp/impl/nanoflann_impl.hpp:867-1418``) and calls it from
the GICP hot loops for 1-NN correspondences (``nano_gicp_impl.hpp:192``) and
k=10/20-NN covariance neighborhoods (``nano_gicp_impl.hpp:313``). Pointer
chasing and per-point branching do not fit fixed-shape array programs, so
this module instead builds a *sorted cell-hash index*:

- quantize points to cells of size equal to the search radius;
- hash cell coords (Teschner-style prime XOR) into an open table of H slots;
- radix-sort points by hash; per-slot [start, count) ranges via scatter;
- a query gathers up to ``cap`` candidates from each of its 27 neighboring
  cells and reduces distances with masks.

Exactness: any neighbor within ``radius`` lies in one of the 27 cells, and
every point of those cells shares their hash slot, so it is among the
candidates (hash collisions only ever *add* candidates, which the distance
comparison filters). The only approximation is the per-slot candidate cap
``cap``; on voxel-downsampled clouds the per-cell occupancy is bounded by
``(cell/voxel + 1)^3`` so caps are chosen to make truncation rare, and
truncation is deterministic (lowest sorted index wins).

All shapes are static; everything runs under ``jit``/``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.core.cloud import PAD_VALUE

_P1, _P2, _P3 = 73856093, 19349669, 83492791  # spatial hash primes (Teschner et al.)

_OFFSETS = [
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
]


class HashGrid(NamedTuple):
    """Sorted-by-hash point index. ``table_size`` is static (from shapes cfg)."""

    points: jnp.ndarray     # [N, 3] f32, permuted into hash order, padded
    src_index: jnp.ndarray  # [N] int32, original index of each sorted point
    mask: jnp.ndarray       # [N] bool, sorted validity
    key2: jnp.ndarray       # [N] int32, independent full-width cell hash:
                            # distinct cells sharing a table slot are told
                            # apart at query time (P[joint collision]~2^-32),
                            # which prevents duplicate candidates across the
                            # 27 neighbor-cell gathers
    start: jnp.ndarray      # [H] int32, first sorted position of each slot
    count: jnp.ndarray      # [H] int32, number of points in each slot
    cell_size: jnp.ndarray  # scalar f32

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def table_size(self) -> int:
        return self.start.shape[0]


def _cell_coords(points: jnp.ndarray, cell_size: jnp.ndarray) -> jnp.ndarray:
    return jnp.floor(points / cell_size).astype(jnp.int32)


def _cell_base(coords: jnp.ndarray) -> jnp.ndarray:
    """Additive-combined cell key (int32 wrap-around).

    NOTE: combining with XOR instead would be subtly broken: for odd
    multipliers ``(-Q)^x == (~Q+1)^x`` makes symmetric offset pairs like
    (0,-1,-1) and (0,1,1) collide *deterministically*
    (``(-Q2)^(-Q3) == Q2^Q3``), producing duplicate NN candidates.
    Additive combining keeps all cells within a ±2 offset neighborhood
    distinct (asserted in tests), and collisions of far-apart cells are
    harmless (distance-filtered).
    """
    return (
        coords[..., 0] * _P1 + coords[..., 1] * _P2 + coords[..., 2] * _P3
    )


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    """Murmur3 finalizer — a *bijective* uint32 mixer."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def _hash_cells(coords: jnp.ndarray, table_size: int) -> jnp.ndarray:
    """[..., 3] int32 -> table slot in [0, table_size)."""
    m = _fmix32(_cell_base(coords).astype(jnp.uint32))
    return jnp.bitwise_and(m, jnp.uint32(table_size - 1)).astype(jnp.int32)


def _hash2_cells(coords: jnp.ndarray) -> jnp.ndarray:
    """Full-width cell identity key. Bijective in the cell base, so key2
    equality <=> base equality; neighbor cells always have distinct bases."""
    m = _fmix32(_cell_base(coords).astype(jnp.uint32) ^ jnp.uint32(0x9E3779B9))
    return m.astype(jnp.int32)


def build(
    points: jnp.ndarray,
    mask: jnp.ndarray,
    cell_size,
    table_size: int,
) -> HashGrid:
    """Build the grid over [N, 3] points. O(N log N) sort + O(N) scatters."""
    n = points.shape[0]
    cell_size = jnp.asarray(cell_size, jnp.float32)
    coords = _cell_coords(points, cell_size)
    h = _hash_cells(coords, table_size)
    h = jnp.where(mask, h, table_size)  # invalid points sort to the end
    order = jnp.argsort(h)
    sh = h[order]
    spts = jnp.where(mask[order][..., None], points[order], PAD_VALUE)
    smask = mask[order]
    sidx = order.astype(jnp.int32)
    skey2 = _hash2_cells(coords)[order]
    positions = jnp.arange(n, dtype=jnp.int32)
    start = jnp.full((table_size,), n, jnp.int32).at[sh].min(positions, mode="drop")
    count = jnp.zeros((table_size,), jnp.int32).at[sh].add(1, mode="drop")
    return HashGrid(
        points=spts, src_index=sidx, mask=smask, key2=skey2, start=start,
        count=count, cell_size=cell_size,
    )


def _neighbor_slot_ranges(grid: HashGrid, queries: jnp.ndarray):
    """Per query: 27 neighbor-cell [start, count) ranges + identity keys.

    [Q, 3] -> (starts [Q, 27], counts [Q, 27], key2 [Q, 27]).
    """
    qcell = _cell_coords(queries, grid.cell_size)  # [Q, 3]
    offs = jnp.asarray(_OFFSETS, jnp.int32)  # [27, 3]
    cells = qcell[:, None, :] + offs[None, :, :]  # [Q, 27, 3]
    hs = _hash_cells(cells, grid.table_size)  # [Q, 27]
    return grid.start[hs], grid.count[hs], _hash2_cells(cells)


def query_1nn(
    grid: HashGrid,
    queries: jnp.ndarray,
    query_mask: jnp.ndarray,
    radius,
    cap: int,
):
    """Nearest neighbor within ``radius`` for each query point.

    Replaces the kd-tree 1-NN of the GICP correspondence loop
    (``nano_gicp_impl.hpp:187-199`` incl. the ``corr_dist_threshold_`` gate).

    Returns (index into the grid's ORIGINAL point order, squared distance,
    found mask). Index is -1 where nothing is found (mirroring the
    reference's ``correspondences_[i] = -1``).
    """
    radius2 = jnp.asarray(radius, jnp.float32) ** 2
    starts, counts, keys2 = _neighbor_slot_ranges(grid, queries)  # [Q, 27]
    q = queries  # [Q, 3]
    best_d2 = jnp.full(q.shape[:1], jnp.inf, jnp.float32)
    best_sorted = jnp.full(q.shape[:1], -1, jnp.int32)
    lane = jnp.arange(cap, dtype=jnp.int32)  # [cap]
    for o in range(27):
        s, c = starts[:, o], counts[:, o]  # [Q]
        cand = s[:, None] + lane[None, :]  # [Q, cap]
        valid = lane[None, :] < jnp.minimum(c, cap)[:, None]
        cand_c = jnp.clip(cand, 0, grid.capacity - 1)
        pts = grid.points[cand_c]  # [Q, cap, 3]
        d2 = jnp.sum((q[:, None, :] - pts) ** 2, axis=-1)
        valid &= grid.key2[cand_c] == keys2[:, o][:, None]
        d2 = jnp.where(valid & grid.mask[cand_c], d2, jnp.inf)
        o_min = jnp.argmin(d2, axis=-1)  # [Q]
        o_d2 = jnp.take_along_axis(d2, o_min[:, None], axis=-1)[:, 0]
        o_idx = jnp.take_along_axis(cand_c, o_min[:, None], axis=-1)[:, 0]
        better = o_d2 < best_d2
        best_d2 = jnp.where(better, o_d2, best_d2)
        best_sorted = jnp.where(better, o_idx, best_sorted)
    found = query_mask & (best_d2 < radius2)
    idx = jnp.where(found, grid.src_index[jnp.clip(best_sorted, 0, None)], -1)
    return idx, best_d2, found


def query_knn(
    grid: HashGrid,
    queries: jnp.ndarray,
    query_mask: jnp.ndarray,
    k: int,
    cap: int,
    chunk: int = 4096,
):
    """k nearest neighbors (within the 27-cell neighborhood ≈ radius cell_size).

    Replaces kd-tree kNN for covariance estimation
    (``nano_gicp_impl.hpp:310-321``). Unlike the reference's unbounded
    search, candidates beyond one cell away are not considered; choose
    ``cell_size`` ≥ the expected k-neighborhood radius. Fewer than k found
    neighbors are masked, and downstream statistics must honor the mask.

    Returns (indices [Q, k] into original order, d2 [Q, k], valid [Q, k]).
    Queries are processed in chunks to bound the [chunk, 27*cap] candidate
    tensor.
    """
    q_total = queries.shape[0]
    assert q_total % chunk == 0, (q_total, chunk)
    lane = jnp.arange(cap, dtype=jnp.int32)

    def do_chunk(args):
        q, qm = args  # [C, 3], [C]
        starts, counts, keys2 = _neighbor_slot_ranges(grid, q)  # [C, 27]
        cand = starts[:, :, None] + lane[None, None, :]  # [C, 27, cap]
        valid = lane[None, None, :] < jnp.minimum(counts, cap)[:, :, None]
        cand_c = jnp.clip(cand, 0, grid.capacity - 1)
        pts = grid.points[cand_c]  # [C, 27, cap, 3]
        valid &= grid.key2[cand_c] == keys2[..., None]
        d2 = jnp.sum((q[:, None, None, :] - pts) ** 2, axis=-1)
        d2 = jnp.where(valid & grid.mask[cand_c], d2, jnp.inf)
        d2f = d2.reshape(q.shape[0], -1)
        candf = cand_c.reshape(q.shape[0], -1)
        # top-k smallest = top-k of negated distances
        neg_d2, pos = jax.lax.top_k(-d2f, k)
        kd2 = -neg_d2
        kidx_sorted = jnp.take_along_axis(candf, pos, axis=-1)
        kvalid = qm[:, None] & jnp.isfinite(kd2)
        kidx = jnp.where(kvalid, grid.src_index[kidx_sorted], -1)
        return kidx, kd2, kvalid

    qs = queries.reshape(-1, chunk, 3)
    qms = query_mask.reshape(-1, chunk)
    kidx, kd2, kvalid = jax.lax.map(do_chunk, (qs, qms))
    return (
        kidx.reshape(q_total, k),
        kd2.reshape(q_total, k),
        kvalid.reshape(q_total, k),
    )
