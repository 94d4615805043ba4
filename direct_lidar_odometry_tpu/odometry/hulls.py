"""Keyframe hull membership — device-side surrogates for QHull.

The reference selects submap keyframes partly from the *convex hull* and
*concave hull* (alpha shape) of keyframe positions, via PCL/QHull on the
host (``odom.cc:1017-1090``). QHull-style incremental algorithms are a
poor fit for XLA; instead of a host callback (which would stall the jitted
step), this module computes hull *membership masks* directly on device:

- **Convex surrogate**: a point is a convex-hull vertex iff it is the
  unique argmax along some direction. Scanning a fixed set of D
  well-spread directions (Fibonacci sphere) yields exactly the dominant
  hull vertices; with D ~ 2x the keyframe count the miss probability for
  vertices that matter (those spanning large solid angle) vanishes. One
  [K,3]x[3,D] matmul + argmax, O(K*D).

- **Concave (alpha-shape) surrogate**: a point is on the alpha-shape
  boundary iff some direction has no neighbor within radius 2*alpha
  further along it (an empty half-space cap locally). Computed as a
  masked [K,K,D] test. The reference uses alpha = the adaptive keyframe
  distance threshold (``odom.cc:1202``).

These run *every frame* inside jit (versus the reference's per-frame QHull
on a growing point set) and are validated against scipy.spatial hulls in
tests — agreement is high for trajectory-shaped point sets, and the
downstream effect is only which nearby keyframes pad the submap.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def fibonacci_directions(d: int) -> np.ndarray:
    """D scan directions: an equatorial ring (60%) plus a Fibonacci sphere
    (40%). Keyframe position sets are near-planar (ground robots), so their
    convex hulls are flattened pancakes whose rim vertices have thin support
    cones concentrated near the horizontal plane — a purely isotropic
    direction set misses them (recall ~0.4 at D=256 vs ~0.9 mixed)."""
    n_ring = int(d * 0.6)
    n_sph = d - n_ring
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    ring = np.stack([np.cos(th), np.sin(th), 0.05 * np.sin(3 * th)], axis=1)
    ring /= np.linalg.norm(ring, axis=1, keepdims=True)
    i = np.arange(n_sph, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / max(n_sph, 1))
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    sph = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=1,
    )
    return np.concatenate([ring, sph]).astype(np.float32)


def convex_membership(
    positions: jnp.ndarray, mask: jnp.ndarray, directions: jnp.ndarray
) -> jnp.ndarray:
    """[K, 3], [K], [D, 3] -> [K] bool — direction-extremal keyframes.

    Mirrors ``computeConvexHull``'s gating: fewer than 4 keyframes -> no
    members (``odom.cc:1019-1022``).
    """
    k = positions.shape[0]
    proj = positions @ directions.T  # [K, D]
    proj = jnp.where(mask[:, None], proj, -jnp.inf)
    best = jnp.argmax(proj, axis=0)  # [D]
    members = jnp.zeros((k,), bool).at[best].set(True)
    enough = jnp.sum(mask) >= 4
    return members & mask & enough


def concave_membership(
    positions: jnp.ndarray,
    mask: jnp.ndarray,
    directions: jnp.ndarray,
    alpha: jnp.ndarray,
) -> jnp.ndarray:
    """[K,3], [K], [D,3], scalar -> [K] bool — alpha-shape boundary surrogate.

    Keyframe i is a boundary point iff for some direction d, no other
    keyframe within radius 2*alpha of i lies further than a small margin
    along d. Gated at >= 5 keyframes like ``computeConcaveHull``
    (``odom.cc:1059-1062``).
    """
    diff = positions[None, :, :] - positions[:, None, :]  # [K, K, 3] j - i
    d2 = jnp.sum(diff * diff, axis=-1)  # [K, K]
    radius2 = (2.0 * alpha) ** 2
    near = (d2 <= radius2) & mask[None, :] & mask[:, None]
    near = near & ~jnp.eye(positions.shape[0], dtype=bool)
    along = jnp.einsum("ijc,dc->ijd", diff, directions)  # [K, K, D]
    margin = 1e-3 * alpha
    blocked = jnp.any(near[:, :, None] & (along > margin), axis=1)  # [K, D]
    boundary = jnp.any(~blocked, axis=-1) & mask
    enough = jnp.sum(mask) >= 5
    return boundary & enough
