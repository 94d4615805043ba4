"""Long-sequence validation: 500-frame closed loop with elevation.

The tuned CI worlds cover 25-93 frames; this exercises the regimes that
only appear at length — keyframe-ring saturation/eviction, submap
re-selection on revisit, loop-closure + pose-graph refinement, drift
accumulation — and reports ATE with and without refinement.

Run on the GPU (production shapes): python tools/long_validation.py
Quick CPU check (small shapes):   SMALL=1 LV_FRAMES=120 JAX_PLATFORMS=cpu \
                                      python tools/long_validation.py
DEGRADE=1 starves the GICP iteration budget (s2s/s2m max_iterations 3/2,
noisier scans) to induce the drift regime real sensors hit — the synthetic
worlds at full budget track at ~0.03 %/m where a loop-closure A/B cannot
show anything. Prints one JSON line per configuration.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.io import evaluation, synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    small = bool(int(os.environ.get("SMALL", "0")))
    n_frames = int(os.environ.get("LV_FRAMES", "500"))
    degrade = bool(int(os.environ.get("DEGRADE", "0")))
    noise = float(os.environ.get("LV_NOISE", "0.03" if degrade else "0.01"))
    # LV_NOISE_BURST="a:b:sigma" — frames [a, b) render with sigma scan
    # noise (a degraded stretch, e.g. rain/dust): odometry genuinely
    # drifts through it, and the revisit afterwards is what loop closure
    # must repair. The clean-world pipeline tracks at ~0.03 %/m where a
    # refinement A/B cannot show anything (measured round 4).
    burst = os.environ.get("LV_NOISE_BURST")
    if burst:
        b_start, b_end, b_sigma = burst.split(":")
        burst = (int(b_start), int(b_end), float(b_sigma))
    base = DloConfig().replace(s2s_prior="constant_velocity")
    if degrade:
        base = base.replace(gicp=dataclasses.replace(
            base.gicp,
            s2s=dataclasses.replace(base.gicp.s2s, max_iterations=3),
            s2m=dataclasses.replace(base.gicp.s2m, max_iterations=2),
            s2m_rescue=False,
        ))
    if small:
        # LV_MAX_KF: ring capacity. The default 24 forces eviction churn
        # (the long-run regime under test); a loop-closure A/B needs a
        # ring that KEEPS the pre-revisit anchor keyframes — with all
        # early keyframes evicted, "loop" edges connect two drifted
        # mid-course keyframes and redistribute error instead of
        # repairing it (measured: map error 0.042 -> 0.080).
        max_kf = int(os.environ.get("LV_MAX_KF", "24"))
        base = base.replace(
            shapes=ShapeConfig(
                n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=max_kf,
                max_submap_kf=8, imu_window=64, grid_table_size=2 ** 14,
                submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
                knn_query_chunk=2048, hull_directions=32,
            ),
        )
        max_range, max_pts, speed = 13.0, 8192, 0.4
    else:
        max_range, max_pts, speed = 40.0, base.shapes.n_raw, 1.0

    rng = np.random.default_rng(11)
    # LV_SOUP=1 restores the legacy point-soup loop world; the default is
    # the round-5 ray-cast closed loop (exact occlusion + beam pattern —
    # the world the bench and the C++ denominator run on)
    if bool(int(os.environ.get("LV_SOUP", "0"))):
        world = synthetic.make_loop_world(
            rng, n_frames=n_frames, speed=speed, z_amplitude=1.5,
            density=25.0 if not small else 6.0,
            ground_density=25.0 if not small else 9.0,
        )
        beams = None
    else:
        world = synthetic.make_urban_world(
            rng, n_frames=n_frames, speed=speed, closed_loop=True,
            z_amplitude=1.5, n_dynamic=2,
        )
        beams = (synthetic.BeamModel(n_beams=32, n_azimuth=512) if small
                 else synthetic.BeamModel())
    scans = None  # rendered lazily per frame: a 500-frame production world
    # does not fit pre-rendered in host RAM comfortably

    for use_pg in (False, True):
        cfg = dataclasses.replace(
            base,
            posegraph=dataclasses.replace(
                base.posegraph, use=use_pg,
                min_index_gap=int(os.environ.get("LV_MIN_GAP", "20")),
                loop_radius=float(os.environ.get("LV_LOOP_RADIUS", "12.0")),
                check_every=64,
            ),
        )
        runner = OdometryRunner(cfg)
        srng = np.random.default_rng(3)
        t0 = time.perf_counter()
        for t in range(n_frames):
            nz = noise
            if burst and burst[0] <= t < burst[1]:
                nz = burst[2]
            scan = synthetic.render_scan(
                world, t, srng, max_range=max_range, max_points=max_pts,
                noise=nz, beams=beams,
            )
            runner.process_scan(scan, float(world.stamps[t]))
        gt_all = np.linalg.inv(world.poses[0])[None] @ world.poses
        gt_pos = gt_all[:, :3, 3]

        def kf_map_error() -> float:
            """Mean error of keyframe positions vs each keyframe's OWN
            ground-truth pose (exact association via KeyframeStore.seq =
            spawn frame index) — the MAP-quality metric loop closure
            actually repairs. Past trajectory poses are already emitted,
            so end-of-run ATE cannot see a final refinement; the
            re-anchored keyframe ring can. (A nearest-point-on-path
            metric is blind to along-track error and mis-scores
            corrections — measured both ways round 4.)"""
            kfc = int(runner.state.keyframes.count)
            pos = np.asarray(runner.state.keyframes.positions[:kfc])
            seq = np.asarray(runner.state.keyframes.seq[:kfc])
            return float(
                np.linalg.norm(pos - gt_pos[seq], axis=-1).mean()
            )

        kf_err_before = kf_map_error()
        if use_pg:
            runner.maybe_refine(force=True)
        kf_err_after = kf_map_error()
        est = runner.trajectory()
        gt = gt_all[: len(est)]
        ate = evaluation.ate(est, gt, align=False)
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
        wall = time.perf_counter() - t0
        print(json.dumps({
            "frames": n_frames,
            "degrade": degrade,
            "noise": noise,
            "posegraph": use_pg,
            "ate_rmse_m": round(float(ate.rmse), 4),
            "ate_max_m": round(float(ate.max), 4),
            "drift_pct": round(100.0 * float(ate.rmse) / max(path, 1e-9), 3),
            "path_m": round(path, 1),
            "keyframes": runner.num_keyframes(),
            "evictions": int(sum(
                1 for s in runner.stats
                if s.result is not None and bool(s.result.kf_evicted)
            )),
            "refine_rounds": len(runner.refine_log) if use_pg else 0,
            "loop_edges": sum(e["n_accepted"] for e in runner.refine_log)
            if use_pg else 0,
            "kf_map_err_before_m": round(kf_err_before, 4),
            "kf_map_err_after_m": round(kf_err_after, 4),
            "wall_s": round(wall, 1),
        }))


if __name__ == "__main__":
    main()
