"""End-to-end benchmark: full odometry pipeline frames/s on one GPU.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
with the measurement protocol and estimator named in the line.

The bench world is an exact ray-cast campus corridor swept by an
OS1-64-class spinning scanner (occlusion, beam pattern, foliage
roughness, moving objects — synthetic.make_urban_world).

Baseline denominator: the reference publishes no numbers, so it is
MEASURED by cpp/dlo_baseline (a from-scratch C++/OpenMP reproduction of
the reference pipeline at reference defaults) on the EXACT same 93-frame
scan sequence: 29.75 fps on a 2-core host (ATE 1.47 cm), extrapolated x4
to the 8-core desktop class the reference targets (README.md, "C++
reference reproduction"). vs_baseline = our_fps / DLO_CPU_FPS. Same-work
note: the voxeled scans (~9-13k pts) sit below the pipeline's n_scan
budget, so NEITHER side thins.

Refuses to measure on anything but a GPU unless ``--cpu`` is given.

Usage: python bench.py [--frames N] [--small] [--cpu] [--stream] [--imu]
                       [--set KEY=VAL] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# measured by cpp/run_baseline.py --frames 93 on a 2-core host (CPU
# numbers of the C++ reference reproduction; see module docstring)
DLO_CPU_FPS_2CORE = 29.75
DLO_CPU_ATE_M = 0.0147
DLO_CPU_FPS = DLO_CPU_FPS_2CORE * 4  # 8-core desktop-class extrapolation


def production_cfg(small: bool = False):
    import dataclasses

    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig

    base = DloConfig()
    # Bench operating point, chosen under the ATE gate on the ray-cast
    # campus world (93 frames):
    # - coarse-only S2S at stride 8 (the full-resolution polish was slower
    #   and slightly worse in ATE)
    # - n_scan 12288: the voxeled ray-cast scan is ~9-13k pts, so this
    #   budget rarely thins at all (16384 gave identical ATE)
    # - n_submap_flat 16384 (ATE 2.0 cm at 32768, 2.3 cm here; 8192 is
    #   past the floor at 4.1 cm)
    # - max_keyframes 128 (128 slots x ~5 m spacing covers ~600 m of map,
    #   plenty for bench sequences; the library default stays 512)
    base = base.replace(
        s2s_prior="constant_velocity",
        host_preprocess=True,
        gicp=dataclasses.replace(
            base.gicp, s2s_full_polish=False, s2s_coarse_stride=8),
        shapes=dataclasses.replace(
            base.shapes, n_scan=12288, n_submap_flat=16384,
            max_keyframes=128),
    )
    if small:
        return base.replace(
            shapes=ShapeConfig(
                n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=64,
                max_submap_kf=8, imu_window=64, grid_table_size=2 ** 14,
                submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
                knn_query_chunk=2048, hull_directions=32,
            )
        )
    return base


def make_bench_world(n_frames: int, rng: np.random.Generator, small: bool,
                     n_dynamic: int | None = None):
    """Returns (world, max_range, max_points, beams).

    The bench world is a campus-corridor BoxWorld rendered by EXACT ray
    casting through a spinning-scanner beam model
    (synthetic.render_raycast, OS1-64 class: 64 beams x 1024 columns,
    +-16.6 deg — the sensor class behind the reference's own acceptance
    rosbag): buildings, trees with diffuse canopies, street clutter,
    moving boxes, true occlusion, radial noise.
    """
    from direct_lidar_odometry_tpu.io import synthetic

    if small:
        beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
        world = synthetic.make_urban_world(
            rng, n_frames=n_frames, speed=0.4, corridor=7.0,
            n_dynamic=1 if n_dynamic is None else n_dynamic,
        )
        return world, 13.0, 8192, beams
    beams = synthetic.BeamModel()
    world = synthetic.make_urban_world(
        rng, n_frames=n_frames, speed=1.0,
        n_dynamic=max(2, n_frames // 25) if n_dynamic is None else n_dynamic,
    )
    return world, 40.0, 131072, beams


def run_batched(args) -> None:
    """Aggregate multi-sequence throughput (the DP axis) on one GPU."""
    import jax
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.parallel import batched

    cfg = production_cfg(args.small)
    b = args.batch
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = make_bench_world(args.frames, rng, args.small)
    init_fn, step_fn = batched.make_batched_fns(cfg)
    states = batched.batched_state(cfg, b)

    # pre-render ALL scans before timing (the single-sequence bench does
    # the same): rendering 4x113k-pt synthetic scans costs ~200 ms of
    # host time and is a property of the data generator, not the pipeline
    print("# rendering scans...", file=sys.stderr)
    frames_data = []
    for t in range(args.frames):
        pts = np.full((b, cfg.shapes.n_raw, 3), 1e6, np.float32)
        mask = np.zeros((b, cfg.shapes.n_raw), bool)
        for i in range(b):
            s = synthetic.render_scan(
                world, t, np.random.default_rng(100 + i),
                max_range=max_range, max_points=max_pts, beams=beams,
            )
            pts[i, : len(s)] = s
            mask[i, : len(s)] = True
        frames_data.append((jnp.asarray(pts), jnp.asarray(mask)))

    # the batched path dispatches per step with two steps in flight
    eye = jnp.tile(jnp.eye(4, dtype=jnp.float32), (b, 1, 1))
    states = init_fn(states, *frames_data[0])
    times = []
    pending = None
    last = None
    for t in range(1, args.frames):
        if t == 4:  # post-warmup: start the clock
            last = time.perf_counter()
        states, res = step_fn(states, *frames_data[t], eye)
        # two steps in flight, like the single-sequence protocol
        if pending is not None and last is not None:
            np.asarray(pending.position)
            now = time.perf_counter()
            times.append(now - last)
            last = now
        pending = res
    np.asarray(pending.position)
    med = float(np.median(times))
    fps = b / med
    print(f"# batched B={b}: {med*1e3:.1f} ms/step median, "
          f"{len(times)} intervals", file=sys.stderr)
    print(json.dumps({
        "metric": "odometry_frames_per_s_per_chip_batched",
        "value": round(fps, 2), "unit": "frames/s",
        "vs_baseline": round(fps / DLO_CPU_FPS, 3),
    }))


def _loop_closure_check(cfg, frames: int = 144, ring: int | None = None,
                        per_frame_detail: bool = False) -> dict:
    """Loop-closure repair measured on THIS device.

    Closed-loop ray-cast world; frames [40, 80) render degraded (range
    cut to 11 m + sigma-0.35 range noise, a fog-like stretch — odometry
    genuinely drifts through it and carries the error to the revisit;
    long_validation's burst protocol, strengthened for the ray-cast
    world's robustness: measured drift 0.64 m, repaired to 0.23 m by one
    loop edge); posegraph refinement on. loop_radius 12 m
    because the last keyframe spawns ~9 m short of closing the circle
    (geometry, not drift). Returns map error before/after the final
    refinement plus the forced-refine wall time.
    The metric is keyframe-map error vs each keyframe's OWN ground-truth
    pose (exact association via KeyframeStore.seq): past trajectory poses
    are already emitted so end-ATE cannot see a final refinement; the
    re-anchored ring — what the exporter and any relocalization consume —
    can.
    """
    import dataclasses

    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    cfg = cfg.replace(
        posegraph=dataclasses.replace(
            cfg.posegraph, use=True, min_index_gap=12, loop_radius=12.0,
            check_every=48, refine_every_kf=8,
        ),
    )
    if ring:
        cfg = cfg.replace(
            shapes=dataclasses.replace(cfg.shapes, max_keyframes=ring))
    rng = np.random.default_rng(21)
    world = synthetic.make_urban_world(
        rng, n_frames=frames, speed=1.0, closed_loop=True, n_dynamic=0)
    beams = synthetic.BeamModel()
    runner = OdometryRunner(cfg)
    srng = np.random.default_rng(5)
    for t in range(frames):
        burst = 40 <= t < 80
        scan = synthetic.render_scan(
            world, t, srng, max_range=11.0 if burst else 40.0,
            max_points=cfg.shapes.n_raw,
            noise=0.35 if burst else 0.01, beams=beams)
        runner.process_scan(scan, float(world.stamps[t]))
    gt_pos = (np.linalg.inv(world.poses[0])[None] @ world.poses)[:, :3, 3]

    def kf_map_error() -> float:
        kfc = int(runner.state.keyframes.count)
        pos = np.asarray(runner.state.keyframes.positions[:kfc])
        seq = np.asarray(runner.state.keyframes.seq[:kfc])
        return float(np.linalg.norm(pos - gt_pos[seq], axis=-1).mean())

    before = kf_map_error()
    t0 = time.perf_counter()
    info = runner.maybe_refine(force=True)
    refine_ms = (time.perf_counter() - t0) * 1e3
    after = kf_map_error()
    out = {
        "frames": frames,
        "ring_slots": int(cfg.shapes.max_keyframes),
        "keyframes": runner.num_keyframes(),
        "loop_edges": sum(e["n_accepted"] for e in runner.refine_log),
        "refine_rounds": len(runner.refine_log),
        "kf_map_err_before_m": round(before, 4),
        "kf_map_err_after_m": round(after, 4),
        "forced_refine_wall_ms": round(refine_ms, 1),
    }
    if per_frame_detail and info is not None:
        out["last_refine"] = {k: round(float(v), 4) if hasattr(v, "__float__")
                              else v for k, v in info.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    # 93 frames = 10 measured chunks of 8 after the warm-up. The ATE gate
    # scales with path length, and the world extent with the frame count.
    ap.add_argument("--frames", type=int, default=93)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (correctness only: its numbers are "
                         "not device metrics)")
    ap.add_argument("--batch", type=int, default=None,
                    help="measure aggregate multi-sequence throughput")
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per device dispatch in the steady loop "
                         "(lax.scan chunking; 1 = per-frame dispatch)")
    ap.add_argument("--inflight", type=int, default=3,
                    help="chunks kept in flight before syncing the oldest "
                         "(--stream protocol)")
    ap.add_argument("--stream", action="store_true",
                    help="encode+upload each chunk just-in-time in a worker "
                         "thread (the online protocol) instead of pre-"
                         "staging all chunks on device before the measured "
                         "loop (the offline-throughput default: staging is "
                         "setup)")
    ap.add_argument("--loop", action="store_true",
                    help="run ONLY the loop-closure repair protocol "
                         "(closed-loop world, noise-burst drift, "
                         "posegraph.use=true) and print its JSON line")
    ap.add_argument("--loop-frames", type=int, default=144)
    ap.add_argument("--loop-ring", type=int, default=None,
                    help="keyframe ring capacity for --loop (bounds the "
                         "synchronous maybe_refine stall at capacity)")
    ap.add_argument("--no-loop", action="store_true",
                    help="skip the compact loop-closure check appended to "
                         "the default run's JSON line")
    ap.add_argument("--imu", action="store_true",
                    help="feed synthesized gyro (from GT, noise+0 bias) "
                         "through runner.push_imu — the reference's hot "
                         "path takes a gyro prior every scan "
                         "(odom.cc:801-806); this exercises it end-to-end")
    ap.add_argument("--dyn", type=int, default=-1,
                    help="override the number of dynamic (moving) boxes "
                         "in the world (-1 = world default) — for "
                         "attribution A/Bs")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the measured loop into DIR with "
                         "jax.profiler (summarize it with "
                         "tools/trace_summary.py); the traced loop's "
                         "number carries the profiler's cost")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="dotted config override for A/B runs, e.g. "
                         "gicp.s2s.optimizer=gn (same syntax as the CLI)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.set:
        from direct_lidar_odometry_tpu import config as config_mod
        from direct_lidar_odometry_tpu.cli import _parse_override

        base = production_cfg
        overrides = dict(_parse_override(s) for s in args.set)

        def production_cfg_with_overrides(small=False, _base=base):
            cfg = _base(small)
            for dotted, value in overrides.items():
                cfg = config_mod._override(cfg, dotted.split("."), value)
            return cfg

        globals()["production_cfg"] = production_cfg_with_overrides

    import jax

    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    if dev.platform != "gpu" and not args.cpu:
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {dev.platform!r}. "
            "Pass --cpu to run on the CPU anyway.")

    if args.batch:
        run_batched(args)
        return

    if args.loop:
        res = _loop_closure_check(
            production_cfg(args.small), frames=args.loop_frames,
            ring=args.loop_ring, per_frame_detail=True)
        print(json.dumps({
            "metric": "loopclosure_map_repair",
            "value": res["kf_map_err_after_m"], "unit": "m", **res,
        }))
        return

    cfg = production_cfg(args.small)
    if args.imu:
        import dataclasses

        # calib_time=0: synthesized gyro is bias-free; the platform is
        # moving from frame 0 so a static calibration window is moot.
        # Buffer sized for the whole run (bench pushes all samples upfront)
        cfg = cfg.replace(imu=dataclasses.replace(
            cfg.imu, use=True, calib_time=0.0,
            buffer_size=max(2000, args.frames * 16)))
    rng = np.random.default_rng(0)

    # Start the step/chunk compiles FIRST, in background threads (AOT on
    # abstract shapes; the persistent compile cache hands the executables
    # to the foreground calls): world generation + rendering below costs
    # tens of seconds of pure host time, which now overlaps the multi-
    # minute cold XLA compile instead of preceding it.
    t_setup = time.perf_counter()
    runner = OdometryRunner(cfg)
    precompile_threads = runner.precompile_async(chunk=args.chunk)

    world, max_range, max_pts, beams = make_bench_world(
        args.frames, rng, args.small,
        n_dynamic=None if args.dyn < 0 else args.dyn)
    print("# rendering scans (overlapping background compiles)...", file=sys.stderr)
    scans = [
        synthetic.render_scan(world, t, rng, max_range=max_range,
                              max_points=max_pts, beams=beams)
        for t in range(args.frames)
    ]
    if args.imu:
        imu_rng = np.random.default_rng(7)
        n_imu = 0
        for t in range(1, len(scans)):
            for row in synthetic.make_imu_between(world, t, 100.0, imu_rng):
                runner.push_imu(float(row[0]), row[1:4], row[4:7])
                n_imu += 1
        print(f"# pushed {n_imu} synthesized IMU samples (100 Hz gyro)",
              file=sys.stderr)
    print(
        f"# {len(scans)} scans, mean {np.mean([len(s) for s in scans]):.0f} raw pts, "
        f"rendered in {time.perf_counter()-t_setup:.1f} s",
        file=sys.stderr,
    )
    warmup = 5
    latencies = []
    for t in range(min(warmup, len(scans))):
        t0 = time.perf_counter()
        runner.process_scan(scans[t], world.stamps[t], sync=True)
        latencies.append(time.perf_counter() - t0)
        print(f"# frame {t}: {latencies[-1]*1e3:.1f} ms (compile/warmup)", file=sys.stderr)

    # throughput: chunked dispatch (lax.scan over K frames per device call)
    # amortizes the fixed per-dispatch host cost, while host prep of chunk
    # i+1 overlaps device compute of chunk i. chunk=1 falls back to per-frame pipelined
    # dispatch synced every flush_every frames.
    chunk = max(1, args.chunk)
    start = warmup
    if chunk > 1 and len(scans) - warmup > chunk:
        tc = time.perf_counter()
        r = runner.process_chunk(
            scans[warmup : warmup + chunk],
            [float(s) for s in world.stamps[warmup : warmup + chunk]],
        )
        np.asarray(r.position)
        print(
            f"# chunk compile ({chunk} frames): {time.perf_counter()-tc:.1f} s",
            file=sys.stderr,
        )
        start = warmup + chunk
    # drain any still-running background compiles (and their persistent-
    # cache disk writes) before the measured loop — they steal host cores
    # from dispatch and skew early chunk timings
    for th in precompile_threads:
        th.join(timeout=300)
    print(
        f"# cold-start to steady state: {time.perf_counter()-t_setup:.1f} s "
        f"(world+render+compiles+warmup)",
        file=sys.stderr,
    )

    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(1)

    def measured_loop(rnr, stream: bool) -> dict:
        """Steady-state loop over scans[start:]; returns timing dict.

        Offline (pre-staged, default) protocol: every chunk's encoded
        input is staged on device BEFORE the clock; all chunk dispatches
        are then enqueued back-to-back and the queue is drained ONCE at
        the end. The wall covers every byte of device compute plus one
        result sync. Estimator: WALL-AVG, queue drained.

        Online (--stream) protocol: chunks are encoded + uploaded just
        in time in a worker thread, `inflight` dispatches deep; the
        oldest result is synced each iteration and the MEDIAN completion
        delta is the estimator.
        """
        n_chunks = max(0, (len(scans) - start) // chunk)
        staged: dict[int, tuple] = {}
        if chunk > 1 and not stream:
            ts = time.perf_counter()
            t = start
            while t + chunk <= len(scans):
                staged[t] = rnr.prepare_chunk(scans[t : t + chunk])
                t += chunk
            # block on EVERY staged upload (device-side, no download):
            # in-flight uploads otherwise stall their chunk's dispatch
            # inside the measured window — staging is setup, the clock
            # must start with inputs resident
            import jax as _jax

            _jax.block_until_ready(list(staged.values()))
            print(f"# pre-staged {len(staged)} chunks in "
                  f"{time.perf_counter()-ts:.1f} s", file=sys.stderr)
        # stream mode: leave >=3 recorded samples after the discarded
        # pipeline-fill pop, else the median degrades to wall-avg
        depth = max(1, min(args.inflight, n_chunks - 4))
        import gc

        gc.collect()
        gc.disable()  # no collector pauses inside the measured window
        t0 = time.perf_counter()
        res = None
        pending: list = []  # completion queue, oldest first
        chunk_times: list[float] = []
        last_sync = t0
        t = start
        prep = (
            ex.submit(rnr.prepare_chunk, scans[start : start + chunk])
            if chunk > 1 and stream and start + chunk <= len(scans)
            else None
        )
        while t < len(scans):
            if chunk > 1 and t + chunk <= len(scans):
                if staged:
                    prepared = staged.pop(t)
                else:
                    prepared = prep.result() if prep is not None else None
                    nxt = t + chunk
                    prep = (
                        ex.submit(rnr.prepare_chunk, scans[nxt : nxt + chunk])
                        if nxt + chunk <= len(scans)
                        else None
                    )
                res = rnr.process_chunk(
                    scans[t : t + chunk],
                    [float(s) for s in world.stamps[t : t + chunk]],
                    prepared=prepared,
                )
                t += chunk
                pending.append(res)
                # stream: keep `depth` chunks in flight, sync the OLDEST —
                # completion deltas measure sustained online throughput.
                # Pre-staged: NO intermediate syncs (see docstring).
                if stream and len(pending) > depth:
                    np.asarray(pending.pop(0).position)
                    now = time.perf_counter()
                    if chunk_times or last_sync != t0:
                        chunk_times.append(now - last_sync)
                    else:
                        pass  # first pop spans the pipeline fill
                    last_sync = now
            else:
                res = rnr.process_scan(
                    scans[t], world.stamps[t], sync=(chunk == 1 and t % 8 == 0)
                )
                t += 1
        # drain: device programs execute in order, so ONE sync on the
        # final result covers every enqueued chunk
        t_enq = time.perf_counter() - t0
        pending.clear()
        if res is not None:
            np.asarray(res.position)
        wall = time.perf_counter() - t0
        gc.enable()
        print(f"# loop phases: enqueue {t_enq*1e3:.0f} ms, drain "
              f"{(wall-t_enq)*1e3:.0f} ms", file=sys.stderr)
        n_steady = len(scans) - start
        out = {"wall_ms": wall / max(n_steady, 1) * 1e3, "n": n_steady}
        if chunk_times:
            print(
                ("# stream " if stream else "# ") + "chunk times (ms/frame): "
                + " ".join(f"{c/chunk*1e3:.1f}" for c in chunk_times),
                file=sys.stderr,
            )
            if len(chunk_times) >= 3:
                out["median_ms"] = float(np.median(chunk_times)) / chunk * 1e3
        return out

    if args.trace:
        jax.profiler.start_trace(args.trace)
    head = measured_loop(runner, stream=args.stream)
    if args.trace:
        jax.profiler.stop_trace()
    ms_wall = head["wall_ms"]
    n_steady = head["n"]
    offline_passes = [ms_wall]
    if args.stream and "median_ms" in head:
        ms, estimator = head["median_ms"], "median_chunk"
    else:
        ms, estimator = ms_wall, "wall_avg"
    protocol = "stream" if args.stream else "prestaged"
    fps = 1000.0 / ms

    # Score the trajectory FIRST, before ANY post-hoc re-stepping of the
    # live donated state (round-4 weak #7: the old code re-stepped the
    # runner on duplicate scans before scoring and correctness hung on a
    # slice). A fast-but-divergent pipeline must not report a score.
    from direct_lidar_odometry_tpu.io import evaluation

    est = runner.trajectory()[: len(world.poses)]
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    ate = evaluation.ate(est, gt, align=False)
    path_len = float(
        np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1))
    )
    # Gate: ~6x the C++ reproduction's measured drift on this exact world
    # (DLO_CPU_ATE_M/93 m = 0.016 %/m), floored at 10 cm — 14x tighter
    # than the round-4 gate; it certifies the accuracy class, not just
    # non-divergence.
    gate = max(0.10, 0.001 * path_len)
    if not np.isfinite(ate.rmse) or ate.rmse > gate:
        print(json.dumps({
            "metric": "odometry_frames_per_s_per_chip",
            "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
            "error": f"diverged: ATE {ate.rmse:.3f} m (gate {gate:.2f})",
        }))
        return

    # The measured window is short, so the offline headline is the
    # MEDIAN of 3 independent passes — each a fresh runner re-processing
    # every measured frame (the trajectory was already scored from pass 1).
    if not args.stream and chunk > 1 and not args.small:
        for _ in range(2):
            rp = OdometryRunner(cfg)
            if args.imu:
                rng_p = np.random.default_rng(7)
                for t in range(1, len(scans)):
                    for row in synthetic.make_imu_between(world, t, 100.0, rng_p):
                        rp.push_imu(float(row[0]), row[1:4], row[4:7])
            for t in range(warmup):
                rp.process_scan(scans[t], world.stamps[t], sync=True)
            r = rp.process_chunk(
                scans[warmup : warmup + chunk],
                [float(s) for s in world.stamps[warmup : warmup + chunk]],
            )
            np.asarray(r.position)
            offline_passes.append(measured_loop(rp, stream=False)["wall_ms"])
        ms = float(np.median(offline_passes))
        ms_wall = ms
        fps = 1000.0 / ms
        estimator = "median_of_3_wall_avg"
        print(f"# offline passes (ms/frame): "
              + " ".join(f"{p:.2f}" for p in offline_passes), file=sys.stderr)

    # min over a few SYNCED chunks (dispatch -> immediate sync, input
    # staged off-clock): bounds the end-to-end latency of one chunk.
    ms_synced = ms
    if chunk > 1 and len(scans) - start >= chunk:
        best_synced = []
        pre = runner.prepare_chunk(scans[-chunk:])  # stage input off-clock
        for _ in range(3):
            tb = time.perf_counter()
            r = runner.process_chunk(
                scans[-chunk:],
                [float(s) + 0.1 for s in world.stamps[-chunk:]],
                prepared=pre,
            )
            np.asarray(r.position)
            best_synced.append(time.perf_counter() - tb)
        ms_synced = min(best_synced) / chunk * 1e3

    # synced single-frame latency for the dashboard line
    t0 = time.perf_counter()
    runner.process_scan(scans[-1], world.stamps[-1] + 0.1, sync=True)
    lat_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"# steady-state: {ms:.2f} ms/frame {estimator} ({ms_synced:.2f} synced-chunk, "
        f"{ms_wall:.2f} wall-avg, {n_steady} frames), {lat_ms:.2f} ms synced latency, "
        f"{runner.num_keyframes()} keyframes, ATE {ate.rmse*100:.2f} cm",
        file=sys.stderr,
    )

    # Online (streamed) number in the same artifact: re-run the measured
    # segment through a FRESH runner with
    # just-in-time encode+upload and report its median-chunk estimator.
    stream_fps = None
    if (not args.stream and chunk > 1 and not args.small
            and len(scans) - start >= 6 * chunk):
        r2 = OdometryRunner(cfg)
        if args.imu:
            imu_rng2 = np.random.default_rng(7)
            for t in range(1, len(scans)):
                for row in synthetic.make_imu_between(world, t, 100.0, imu_rng2):
                    r2.push_imu(float(row[0]), row[1:4], row[4:7])
        for t in range(warmup):
            r2.process_scan(scans[t], world.stamps[t], sync=True)
        r = r2.process_chunk(
            scans[warmup : warmup + chunk],
            [float(s) for s in world.stamps[warmup : warmup + chunk]],
        )
        np.asarray(r.position)
        sec = measured_loop(r2, stream=True)
        stream_fps = 1000.0 / sec.get("median_ms", sec["wall_ms"])
        print(f"# online (stream) protocol: {1000.0/stream_fps:.2f} ms/frame "
              f"median-chunk", file=sys.stderr)

    out = {
        "metric": "odometry_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / DLO_CPU_FPS, 3),
        # same-work: on this world the voxeled scan (~9-13k pts) is BELOW
        # the pipeline's n_scan budget, so neither side thins — the two
        # ratios coincide by construction (cpp/run_baseline --thin is the
        # knob that would equalize budgets on denser data)
        "vs_baseline_same_work": round(fps / DLO_CPU_FPS, 3),
        "vs_cpu_same_host_2core": round(fps / DLO_CPU_FPS_2CORE, 3),
        "protocol": protocol,
        "estimator": estimator,
        "offline_passes_ms_per_frame": [round(p, 2) for p in offline_passes],
        "wall_avg_fps": round(1000.0 / ms_wall, 2),
        "synced_chunk_fps": round(1000.0 / ms_synced, 2),
        "ate_rmse_m": round(float(ate.rmse), 4),
        "ate_pct_per_m": round(float(ate.rmse) / max(path_len, 1e-9) * 100, 4),
        "gate_m": round(gate, 3),
        "cpu_baseline_fps_2core_measured": DLO_CPU_FPS_2CORE,
        "cpu_baseline_ate_m": DLO_CPU_ATE_M,
    }
    if stream_fps is not None:
        out["stream_fps"] = round(stream_fps, 2)
        out["vs_baseline_stream"] = round(stream_fps / DLO_CPU_FPS, 3)
    # compact loop-closure repair evidence in the same line
    if not args.no_loop and not args.small and not args.cpu:
        out["loopclosure"] = _loop_closure_check(production_cfg(False))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
