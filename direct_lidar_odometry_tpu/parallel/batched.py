"""Multi-sequence batched odometry — the throughput axis.

The reference is a single-robot, single-process system with no distributed
capability (SURVEY.md §2 parallelism accounting). Odometry is inherently
sequential in time, so the device throughput axis is *batching independent
sequences*: the per-frame step is pure, so ``vmap`` turns it into a
``[B, ...]`` step with zero code change, and ``shard_map`` (see
``sharded.py``) lays the batch over a device mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import DloConfig
from direct_lidar_odometry_tpu.odometry import hulls, pipeline
from direct_lidar_odometry_tpu.odometry.state import OdomState


def batched_state(cfg: DloConfig, batch: int) -> OdomState:
    """Stack ``batch`` fresh per-sequence states along a leading axis."""
    one = pipeline.fresh_state(cfg)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), one
    )


def make_batched_fns(cfg: DloConfig) -> tuple[Callable, Callable]:
    """(init_fn, step_fn) vmapped over a leading sequence axis.

    init_fn(states[B], raw_points[B,N,3], raw_mask[B,N]) -> states
    step_fn(states, raw_points, raw_mask, imu_priors[B,4,4])
        -> (states, FrameResult[B])

    Callers feed RAW scans, so host preprocessing (a single-sequence
    runner optimization) is force-disabled here: with it left on, the
    pipeline would skip device preprocessing and register unvoxelized
    clouds.
    """
    from direct_lidar_odometry_tpu.config import resolve_backend

    from direct_lidar_odometry_tpu.utils.precision import f32_matmuls

    cfg = cfg.replace(host_preprocess=False)
    backend = resolve_backend(cfg)
    directions = hulls.fibonacci_directions(cfg.shapes.hull_directions)
    init = jax.vmap(partial(pipeline.init_frame, cfg, backend))
    step = jax.vmap(partial(pipeline.odom_frame, cfg, backend, directions))
    return jax.jit(f32_matmuls(init)), jax.jit(f32_matmuls(step))
