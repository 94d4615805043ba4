"""Scaling-efficiency harness: aggregate odometry throughput vs device count.

Measures the sharded multi-sequence step (parallel/sharded.py) at N = 1, 2,
4, 8 devices with a FIXED per-device batch (weak scaling — the deployment
axis: more chips, more sequences). Efficiency(N) = fps(N) / (N * fps(1)).

Run CPU-mesh:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
               JAX_PLATFORMS=cpu python tools/scaling_bench.py
Prints one JSON line per N plus a summary row.

CAVEAT for the CPU mesh on this box: the 8 virtual devices share 2 physical
cores, so measured efficiency at N >= 4 is bounded by core count, not by
the sharding design (there are no cross-device collectives in the step —
it is embarrassingly parallel by construction; the only communication is
the psum'd fleet-health scalar). On a real pod the per-chip work is
identical and independent, so the design-level efficiency is ~1.0 minus
the psum latency. jax.distributed multi-host init is provided by
``sharded.init_distributed`` for real multi-host runs.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    # CPU virtual devices unless SCALING_PLATFORM names another platform
    if os.environ.get("SCALING_PLATFORM", "cpu") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.parallel import batched, sharded

    per_device = int(os.environ.get("SCALING_BATCH", "2"))
    frames = int(os.environ.get("SCALING_FRAMES", "10"))
    cfg = DloConfig().replace(
        quantize_transfer=False,
        s2s_prior="constant_velocity",
        shapes=ShapeConfig(
            n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=64,
            max_submap_kf=8, imu_window=64, grid_table_size=2 ** 14,
            submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
            knn_query_chunk=2048, hull_directions=32,
        ),
    )
    n_avail = len(jax.devices())
    print(f"# devices available: {n_avail} ({jax.devices()[0].platform})",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    world = synthetic.make_world(
        rng, n_frames=frames, extent=15.0, n_boxes=6, speed=0.4,
        ground_points=8000, density=6.0,
    )

    def scans_for(b, t):
        pts = np.full((b, cfg.shapes.n_raw, 3), 1e6, np.float32)
        mask = np.zeros((b, cfg.shapes.n_raw), bool)
        for i in range(b):
            s = synthetic.render_scan(
                world, t, np.random.default_rng(100 + i),
                max_range=13.0, max_points=8192,
            )
            pts[i, : len(s)] = s
            mask[i, : len(s)] = True
        return pts, mask

    results = []
    sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]
    if os.environ.get("SCALING_SIZES"):
        # e.g. SCALING_SIZES=2 taskset -c 0,1 python tools/scaling_bench.py
        # — pin device count to physical cores for apples-to-apples
        # efficiency on a host with fewer cores than virtual devices
        sizes = [int(s) for s in os.environ["SCALING_SIZES"].split(",")]
    for n in sizes:
        b = per_device * n
        mesh = sharded.make_mesh(n)
        step = sharded.make_sharded_step(cfg, mesh)
        init_fn, _ = batched.make_batched_fns(cfg)
        states = sharded.shard_states(batched.batched_state(cfg, b), mesh)
        eye = jnp.tile(jnp.eye(4, dtype=jnp.float32), (b, 1, 1))

        pts, mask = scans_for(b, 0)
        states = init_fn(states, jnp.asarray(pts), jnp.asarray(mask))
        # warmup (compile)
        pts, mask = scans_for(b, 1)
        out = step(states, jnp.asarray(pts), jnp.asarray(mask), eye)
        jax.block_until_ready(out)
        states = out[0]

        times = []
        skews = []
        for t in range(2, frames):
            pts, mask = scans_for(b, t)
            pts, mask = jnp.asarray(pts), jnp.asarray(mask)
            t0 = time.perf_counter()
            states, res, mean_corr, max_err = step(states, pts, mask, eye)
            np.asarray(res.position)
            times.append(time.perf_counter() - t0)
            # Dispatch-skew proxy: the step's cost is dominated by data-
            # dependent while_loop trip counts, and a sharded step
            # completes at its SLOWEST shard. Per-device iteration totals
            # (s2s+s2m, summed over the device's sequences) bound the
            # work imbalance the mesh pays; (max-min)/mean is the
            # fractional skew a real pod would see on this workload.
            it = (np.asarray(res.s2s_iterations, np.float64)
                  + np.asarray(res.s2m_iterations, np.float64))
            per_dev = it.reshape(n, -1).sum(axis=1)
            skews.append((per_dev.max() - per_dev.min())
                         / max(per_dev.mean(), 1e-9))
        med = float(np.median(times))
        fps = b / med
        results.append((n, b, med * 1e3, fps))
        print(json.dumps({
            "devices": n, "batch": b, "ms_per_step": round(med * 1e3, 1),
            "aggregate_fps": round(fps, 2),
            "iter_skew_frac_mean": round(float(np.mean(skews)), 3),
            "iter_skew_frac_max": round(float(np.max(skews)), 3),
        }))

    base = results[0][3]
    print(json.dumps({
        "metric": "scaling_efficiency",
        "table": [
            {"devices": n, "aggregate_fps": round(fps, 2),
             "efficiency": round(fps / (n * base), 3)}
            for n, _, _, fps in results
        ],
    }))


if __name__ == "__main__":
    main()
