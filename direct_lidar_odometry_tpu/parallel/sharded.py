"""Device-mesh sharding: multi-sequence odometry + distributed refinement.

The reference has no multi-node capability at all (SURVEY.md §2); this is
the genuinely new distributed layer, built the JAX way: a ``Mesh`` with a
``seq`` axis, batched odometry states sharded along it via ``shard_map``,
and pose-graph refinement whose normal-equation contributions are
``psum``-reduced over an ``edge`` axis (XLA hands the collectives to NCCL
over NVLink; the solve is replicated — the Schur-reduction recipe from
BASELINE.json). The mesh is flat over ``jax.devices()``: every card
reaches every other at the same rate, so its shape follows the algorithm.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from direct_lidar_odometry_tpu.config import DloConfig
from direct_lidar_odometry_tpu.odometry import hulls, pipeline
from direct_lidar_odometry_tpu.parallel import posegraph


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: initialize the jax.distributed runtime.

    Pass the coordinator address ``host:port``, world size, and rank — or
    set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID. With
    none given, JAX auto-detects a cluster it knows (SLURM, Open MPI,
    Kubernetes); where it finds none the process runs alone. After this,
    ``jax.devices()`` spans all hosts and :func:`make_mesh` builds a global
    mesh; the sharded step and distributed refine work unchanged. Safe to
    call once per process; subsequent calls are ignored.

    Must run before any JAX computation or device query in the process —
    even ``jax.process_count()`` initializes the backend, after which the
    distributed runtime can no longer attach (this function therefore
    checks initialization via ``jax.distributed.is_initialized``, not a
    device/process query). Exercised for real by
    tests/test_distributed.py (2 processes, localhost coordinator).
    """
    import jax

    if jax.distributed.is_initialized():  # already initialized
        return
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        jax.distributed.initialize(  # misconfiguration must be loud
            coordinator_address=coordinator,
            num_processes=num_processes
            or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=process_id or int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
        return
    try:
        jax.distributed.initialize()  # cluster auto-detection
    except ValueError as e:
        if "coordinator_address" not in str(e):
            raise
        # no cluster detected: a single process, nothing to initialize


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Align all processes at a named coordination-service barrier.

    Cross-process collectives bootstrap their communicator with a fixed
    ~30 s key-exchange deadline; if hosts reach the first collective more
    than that apart (cold compiles skew them), bring-up fails. Call this
    after AOT-compiling (``fn.lower(...).compile()``) and before the first
    execution so all hosts enter the collective together. No-op when the
    distributed runtime is not initialized (single process).
    """
    from jax._src import distributed

    client = distributed.global_state.client
    if client is None:  # single-process: nothing to align
        return
    client.wait_at_barrier(name, timeout_in_ms=int(timeout_s * 1000))


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), (axis,))


def shard_states(states, mesh: Mesh, axis: str = "seq"):
    """Place a batched state pytree with the batch axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(states, sharding)


def make_sharded_step(cfg: DloConfig, mesh: Mesh, axis: str = "seq") -> Callable:
    """Batched odometry step with the sequence axis sharded over the mesh.

    step(states[B], raw_points[B,N,3], raw_mask[B,N], imu[B,4,4])
        -> (states, FrameResult[B]);  B must be divisible by mesh size.

    Odometry frames are independent across sequences, so the step itself
    needs no collectives — sharding the batch is pure data parallelism.
    A global health reduction (mean correspondence count, max error) is
    psum'd across the mesh as the cross-sequence fleet signal.
    """
    from direct_lidar_odometry_tpu.config import resolve_backend

    # raw scans come in over the mesh; host preprocessing is a
    # single-sequence runner optimization (see parallel/batched.py)
    cfg = cfg.replace(host_preprocess=False)
    backend = resolve_backend(cfg)
    directions = hulls.fibonacci_directions(cfg.shapes.hull_directions)
    local_step = jax.vmap(partial(pipeline.odom_frame, cfg, backend, directions))
    spec = P(axis)

    def sharded(states, pts, mask, imu):
        states, res = local_step(states, pts, mask, imu)
        # fleet health: global mean S2M correspondences + max error (psum)
        n = jax.lax.psum(jnp.sum(res.s2m_num_corr), axis)
        cnt = jax.lax.psum(res.s2m_num_corr.shape[0], axis)
        mean_corr = n / cnt
        max_err = jax.lax.pmax(jnp.max(res.s2m_error), axis)
        return states, res, mean_corr, max_err

    from direct_lidar_odometry_tpu.utils.precision import f32_matmuls

    return jax.jit(f32_matmuls(
        jax.shard_map(
            sharded, mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, P(), P()),
            check_vma=False,  # while_loop carries from literals trip the
                              # varying-axis checker; semantics unaffected
        )
    ))


def make_distributed_refine(
    mesh: Mesh, axis: str = "edge", iterations: int = 5
) -> Callable:
    """Pose-graph refinement with edges sharded over the mesh.

    refine(graph with edges/rel/edge_mask/weights sharded on axis 0)
        -> (poses replicated, error scalar)
    """
    spec_edges = posegraph.PoseGraph(
        poses=P(), pose_mask=P(),
        edges=P(axis), rel=P(axis), edge_mask=P(axis), weights=P(axis),
    )

    def run(graph: posegraph.PoseGraph):
        return posegraph.refine(graph, iterations=iterations, axis_name=axis)

    from direct_lidar_odometry_tpu.utils.precision import f32_matmuls

    return jax.jit(f32_matmuls(
        jax.shard_map(
            run, mesh=mesh,
            in_specs=(spec_edges,),
            out_specs=(P(), P()),
            check_vma=False,
        )
    ))
