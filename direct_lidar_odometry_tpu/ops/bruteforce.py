"""Brute-force neighbor search: exhaustive tiled distance reductions.

The plain reference for every 1-NN path (exact, no index, no candidate
caps) and the "brute" backend. Each tile is a subtract/square/min
reduction over a [Q, tile] block with a running (min, argmin) carry, work
that XLA fuses; cost is O(Q*T) regardless of point density, which is the
opposite trade to the reference's kd-tree (``nanoflann_impl.hpp:1355-1418``)
and the hash grid (ops/hashgrid.py).

Distances use the difference form ``sum((q - t)^2)`` rather than the
norm-expansion matmul trick: with world-frame coordinates at hundreds of
meters, ``|p|^2`` cancellation in f32 would cost ~0.1 m^2 of resolution.
Nothing of shape [Q, T, 3] is formed; XLA fuses the subtract/square/reduce.

Contracts match :mod:`direct_lidar_odometry_tpu.ops.hashgrid` queries:
indices into the target's original order, -1 / masked where not found.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def query_1nn(
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    queries: jnp.ndarray,
    query_mask: jnp.ndarray,
    radius,
    tile: int = 8192,
):
    """Exact 1-NN within ``radius``: ([T,3],[T],[Q,3],[Q]) -> (idx, d2, found).

    Tiles the target axis with a running (min, argmin) carry so the
    per-step working set is [Q, tile]; a partial last tile is padded with
    masked-out targets.
    """
    t_total = target_points.shape[0]
    n_tiles = -(-t_total // tile)
    pad = n_tiles * tile - t_total
    if pad:
        target_points = jnp.pad(target_points, ((0, pad), (0, 0)))
        target_mask = jnp.pad(target_mask, (0, pad))
    radius2 = jnp.asarray(radius, jnp.float32) ** 2
    tpts = target_points.reshape(n_tiles, tile, 3)
    tmask = target_mask.reshape(n_tiles, tile)

    def body(carry, inp):
        best_d2, best_idx = carry
        tp, tm, base = inp
        d2 = jnp.sum((queries[:, None, :] - tp[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(tm[None, :], d2, jnp.inf)
        arg = jnp.argmin(d2, axis=-1)
        tile_d2 = jnp.take_along_axis(d2, arg[:, None], axis=-1)[:, 0]
        better = tile_d2 < best_d2
        best_d2 = jnp.where(better, tile_d2, best_d2)
        best_idx = jnp.where(better, base + arg.astype(jnp.int32), best_idx)
        return (best_d2, best_idx), None

    init = (
        jnp.full(queries.shape[:1], jnp.inf, jnp.float32),
        jnp.full(queries.shape[:1], -1, jnp.int32),
    )
    bases = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    (best_d2, best_idx), _ = jax.lax.scan(body, init, (tpts, tmask, bases))
    found = query_mask & (best_d2 < radius2)
    idx = jnp.where(found, best_idx, -1)
    return idx, best_d2, found


def query_knn(
    target_points: jnp.ndarray,
    target_mask: jnp.ndarray,
    queries: jnp.ndarray,
    query_mask: jnp.ndarray,
    k: int,
    chunk: int = 2048,
):
    """Exact k-NN (unbounded radius, like the reference's kd-tree kNN).

    Chunks the query axis; each chunk materializes [chunk, T] distances
    and runs ``lax.top_k``. Used once per scan for normal estimation.
    Returns (idx [Q,k], d2 [Q,k], valid [Q,k]).
    """
    q_total = queries.shape[0]
    assert q_total % chunk == 0, (q_total, chunk)

    def do_chunk(args):
        q, qm = args
        d2 = jnp.sum((q[:, None, :] - target_points[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(target_mask[None, :], d2, jnp.inf)
        neg, idx = jax.lax.top_k(-d2, k)
        kd2 = -neg
        valid = qm[:, None] & jnp.isfinite(kd2)
        return jnp.where(valid, idx, -1), kd2, valid

    qs = queries.reshape(-1, chunk, 3)
    qms = query_mask.reshape(-1, chunk)
    idx, d2, valid = jax.lax.map(do_chunk, (qs, qms))
    return (
        idx.reshape(q_total, k),
        d2.reshape(q_total, k),
        valid.reshape(q_total, k),
    )
