"""Morton (Z-order) codes.

Host preprocessing (io/hostprep.py, cpp/dlo_host.cpp) emits each scan's
voxel centroids in Z-order, and :func:`ops.voxel.voxel_downsample_morton`
is its device-side reference. Z-order keeps consecutive points spatially
close, so a strided subsample of a scan (the coarse S2S stage,
odometry/pipeline.py) is spread evenly through space, and a capacity
overflow drops voxels evenly along the curve.
"""

from __future__ import annotations

import jax.numpy as jnp

# quantization cell for the 10-bit-per-axis Morton code. Only locality
# quality depends on this, never correctness; 1024 cells cover +-256 m.
DEFAULT_CELL = 0.5


def _part_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of ``x`` so there are 2 zeros between bits."""
    x = x.astype(jnp.uint32)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton_codes(
    points: jnp.ndarray, mask: jnp.ndarray, cell: float = DEFAULT_CELL
) -> jnp.ndarray:
    """[N,3],[N] -> uint32 Z-order codes; invalid points sort last.

    The origin is the masked minimum, so codes are translation-invariant
    per cloud and the 10-bit range is spent on the cloud's actual extent.
    """
    origin = jnp.min(jnp.where(mask[:, None], points, jnp.inf), axis=0)
    origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
    q = jnp.clip((points - origin) / cell, 0.0, 1023.0).astype(jnp.uint32)
    code = _part_bits(q[:, 0]) | (_part_bits(q[:, 1]) << 1) | (_part_bits(q[:, 2]) << 2)
    return jnp.where(mask, code, jnp.uint32(0xFFFFFFFF))
