"""Worker process for the 2-process jax.distributed test.

Launched (twice) by tests/test_distributed.py:
    python distributed_worker.py <rank> <coordinator_port>

Each process owns 4 virtual CPU devices; `sharded.init_distributed` joins
them into one 8-device world. The worker then:

1. runs the sharded multi-sequence odometry step over the GLOBAL mesh
   (batch axis crosses the process boundary — the DCN analog) and asserts
   its addressable shards equal a locally-computed single-process vmap
   reference on identical data;
2. runs the edge-sharded distributed pose-graph refinement over the global
   mesh and asserts it equals local `posegraph.refine`.

This is the real multi-process bring-up path (SURVEY.md §5 "distributed
communication backend") — the in-process mesh tests in test_parallel.py
never cross a process boundary.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)

import jax

jax.config.update("jax_platforms", "cpu")

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_TESTS))
sys.path.insert(0, _TESTS)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main(rank: int, port: str) -> None:
    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.parallel import batched, posegraph, sharded

    sharded.init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    assert jax.process_count() == 2, f"distributed init failed: {jax.process_count()}"
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4, jax.local_device_count()

    cfg = DloConfig().replace(
        shapes=ShapeConfig(
            n_raw=2048, n_scan=2048, n_keyframe=1024, max_keyframes=16,
            max_submap_kf=4, imu_window=32, grid_table_size=2 ** 12,
            submap_table_size=2 ** 12, cell_cap_1nn=8, cell_cap_knn=32,
            knn_query_chunk=1024, hull_directions=16,
        )
    )
    B = 8

    # deterministic data, identical on both processes: frame 1 is a rigid
    # shift of frame 0, so S2S must recover the shift
    rng = np.random.default_rng(0)
    pts0 = rng.uniform(-10, 10, size=(B, cfg.shapes.n_raw, 3)).astype(np.float32)
    shift = np.array([0.2, 0.1, 0.0], np.float32)
    pts1 = pts0 + shift
    mask = np.ones((B, cfg.shapes.n_raw), bool)
    eye = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))

    # ---- local single-process reference (plain vmap, local devices) ----
    init_fn, step_fn = batched.make_batched_fns(cfg)
    states_ref = batched.batched_state(cfg, B)
    states_ref = init_fn(states_ref, jnp.asarray(pts0), jnp.asarray(mask))
    states_np = jax.tree_util.tree_map(np.asarray, states_ref)
    _, res_ref = step_fn(states_ref, jnp.asarray(pts1), jnp.asarray(mask),
                         jnp.asarray(eye))
    ref_pos = np.asarray(res_ref.position)
    ref_corr = float(np.mean(np.asarray(res_ref.s2m_num_corr)))

    # ---- distributed: seq axis sharded over the global 8-device mesh ----
    mesh = sharded.make_mesh(8)
    sharding = NamedSharding(mesh, P("seq"))

    def gshard(full_np):
        arr = np.asarray(full_np)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    states_g = jax.tree_util.tree_map(gshard, states_np)
    step = sharded.make_sharded_step(cfg, mesh)
    args_g = (states_g, gshard(pts1), gshard(mask), gshard(eye))
    # AOT-compile first, then barrier: the first collective's communicator
    # bootstrap has a ~30 s key-exchange deadline, and cold compiles skew
    # the two processes far beyond that on a contended box.
    step_c = step.lower(*args_g).compile()
    sharded.barrier("step_compiled")
    states_g, res, mean_corr, max_err = step_c(*args_g)
    jax.block_until_ready(res.position)

    # psum'd fleet health is replicated -> readable on every process, and
    # must equal the local batch mean (all processes saw the same data)
    assert np.isfinite(float(max_err))
    np.testing.assert_allclose(float(mean_corr), ref_corr, rtol=1e-6)

    # each process checks ITS shards against the local reference
    checked = 0
    for shard in res.position.addressable_shards:
        b0 = shard.index[0].start or 0
        data = np.asarray(shard.data)
        np.testing.assert_allclose(
            data, ref_pos[b0 : b0 + data.shape[0]], atol=1e-5
        )
        checked += data.shape[0]
    assert checked == 4, checked  # 4 sequences live on this process

    # the step must actually have recovered the rigid shift: moving the
    # WORLD points by +s means the sensor moved by -s
    for b in range(B):
        assert np.linalg.norm(ref_pos[b] + shift) < 0.05, ref_pos[b]

    # ---- distributed pose-graph refinement across the boundary ----
    from test_parallel import make_noisy_chain

    gt, noisy, edges, rels, emask = make_noisy_chain(
        np.random.default_rng(1), k=10, m=16
    )
    graph = posegraph.PoseGraph(
        poses=jnp.asarray(noisy),
        pose_mask=jnp.ones((len(gt),), bool),
        edges=jnp.asarray(edges),
        rel=jnp.asarray(rels),
        edge_mask=jnp.asarray(emask),
        weights=jnp.ones((len(edges),), jnp.float32),
    )
    single, err_s = posegraph.refine(graph, iterations=5)

    emesh = sharded.make_mesh(8, axis="edge")
    espec = NamedSharding(emesh, P("edge"))
    repl = NamedSharding(emesh, P())
    graph_g = posegraph.PoseGraph(
        poses=jax.make_array_from_callback(
            noisy.shape, repl, lambda idx: noisy[idx]
        ),
        pose_mask=jax.make_array_from_callback(
            (len(gt),), NamedSharding(emesh, P()), lambda idx: np.ones((len(gt),), bool)[idx]
        ),
        edges=jax.make_array_from_callback(
            edges.shape, espec, lambda idx: edges[idx]
        ),
        rel=jax.make_array_from_callback(rels.shape, espec, lambda idx: rels[idx]),
        edge_mask=jax.make_array_from_callback(
            emask.shape, espec, lambda idx: emask[idx]
        ),
        weights=jax.make_array_from_callback(
            (len(edges),), espec,
            lambda idx: np.ones((len(edges),), np.float32)[idx],
        ),
    )
    dist_fn = sharded.make_distributed_refine(emesh, iterations=5)
    dist_c = dist_fn.lower(graph_g).compile()
    sharded.barrier("refine_compiled")
    dist, err_d = dist_c(graph_g)
    jax.block_until_ready(dist)
    np.testing.assert_allclose(np.asarray(single), np.asarray(dist), atol=2e-4)
    np.testing.assert_allclose(float(err_s), float(err_d), rtol=1e-3, atol=1e-9)

    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
