"""Worker for the cross-process scaling harness (tools/scaling_procs.py).

Launched as: python scaling_procs_worker.py <rank> <nprocs> <port> <steps>

One virtual CPU device per OS process; `sharded.init_distributed` joins
them into an nprocs-device world. Each process owns ONE sequence of the
batch axis; the harness times the sharded multi-sequence step across the
real process boundary (the round-4 verdict's missing data point: the
in-process virtual-mesh numbers measure core contention, and the
2-process correctness test measures nothing about efficiency).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ.pop("JAX_PLATFORMS", None)

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import time

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main(rank: int, nprocs: int, port: str, steps: int) -> None:
    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.parallel import batched, sharded

    if nprocs > 1:
        sharded.init_distributed(
            f"127.0.0.1:{port}", num_processes=nprocs, process_id=rank)
        assert jax.process_count() == nprocs
    assert jax.device_count() == nprocs, jax.device_count()

    cfg = DloConfig().replace(
        shapes=ShapeConfig(
            n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=32,
            max_submap_kf=8, imu_window=32, grid_table_size=2 ** 14,
            submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
            knn_query_chunk=2048, hull_directions=16,
        )
    )
    B = nprocs  # one sequence per device/process

    rng = np.random.default_rng(0)
    pts0 = rng.uniform(-10, 10, size=(B, cfg.shapes.n_raw, 3)).astype(np.float32)
    pts1 = pts0 + np.array([0.2, 0.1, 0.0], np.float32)
    mask = np.ones((B, cfg.shapes.n_raw), bool)
    eye = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    init_fn, _ = batched.make_batched_fns(cfg)
    states = batched.batched_state(cfg, B)
    states = init_fn(states, jnp.asarray(pts0), jnp.asarray(mask))
    states_np = jax.tree_util.tree_map(np.asarray, states)

    mesh = sharded.make_mesh(nprocs)
    sharding = NamedSharding(mesh, P("seq"))

    def gshard(full_np):
        arr = np.asarray(full_np)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    states_g = jax.tree_util.tree_map(gshard, states_np)
    step = sharded.make_sharded_step(cfg, mesh)
    args = (states_g, gshard(pts1), gshard(mask), gshard(eye))
    step_c = step.lower(*args).compile()
    if nprocs > 1:
        sharded.barrier("compiled")
    # warmup
    states_g, res, mc, me = step_c(*args)
    jax.block_until_ready(res.position)
    t0 = time.perf_counter()
    for _ in range(steps):
        states_g, res, mc, me = step_c(
            states_g, gshard(pts1), gshard(mask), gshard(eye))
    jax.block_until_ready(res.position)
    wall = time.perf_counter() - t0
    if nprocs > 1:
        sharded.barrier("timed")
    agg_fps = B * steps / wall
    print(f"WORKER_FPS rank={rank} agg_fps={agg_fps:.3f} wall={wall:.2f}",
          flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
