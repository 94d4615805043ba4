"""Chunked-dispatch hull staleness: measured ATE vs chunk size.

In chunked mode the exact host hull masks are constant for a whole chunk,
so submap selection can run against memberships up to K frames old
(pipeline.make_chunked_step_fn). The reference tolerates 1 frame of
staleness (odom.cc:1309); this sweep MEASURES the cost of K on a
constantly-turning closed-loop trajectory — the worst case for stale
hulls — instead of assuming it.

CPU (small shapes):  JAX_PLATFORMS=cpu python tools/staleness_sweep.py
GPU (production):    SMALL=0 python tools/staleness_sweep.py
Env: SS_FRAMES (default 96), SS_CHUNKS (default "1,8,16,32").
Prints one JSON line per chunk size.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
    from direct_lidar_odometry_tpu.io import evaluation, synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    small = bool(int(os.environ.get("SMALL", "1")))
    n_frames = int(os.environ.get("SS_FRAMES", "96"))
    chunks = [int(c) for c in os.environ.get("SS_CHUNKS", "1,8,16,32").split(",")]

    base = DloConfig().replace(s2s_prior="constant_velocity", host_preprocess=True)
    if small:
        base = base.replace(shapes=ShapeConfig(
            n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=24,
            max_submap_kf=8, imu_window=64, grid_table_size=2 ** 14,
            submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
            knn_query_chunk=2048, hull_directions=32,
        ))
        max_range, max_pts, speed = 13.0, 8192, 0.4
    else:
        max_range, max_pts, speed = 40.0, base.shapes.n_raw, 1.0

    # closed loop = constant turning; thresh_dist forced low so keyframes
    # spawn often enough that hull membership actually changes within a
    # chunk (the staleness mechanism under test)
    import dataclasses
    base = dataclasses.replace(
        base,
        keyframe=dataclasses.replace(base.keyframe, thresh_dist=2.0),
        adaptive=dataclasses.replace(base.adaptive, use=False),
    )
    rng = np.random.default_rng(5)
    # round-5: ray-cast closed loop (STALE_SOUP=1 restores the legacy
    # point-soup world round 4 measured on)
    if bool(int(os.environ.get("STALE_SOUP", "0"))):
        world = synthetic.make_loop_world(
            rng, n_frames=n_frames, speed=speed, z_amplitude=1.0,
            density=25.0 if not small else 6.0,
            ground_density=25.0 if not small else 9.0,
        )
        beams = None
    else:
        # closed-loop radius = speed*n_frames/(2pi) must clear the
        # corridor offset, or inner-side buildings crowd the loop centre
        # and the path clips them (solid interiors return nothing)
        speed = max(speed, 2 * np.pi * 11.0 / n_frames) if small else speed
        world = synthetic.make_urban_world(
            rng, n_frames=n_frames, speed=speed, closed_loop=True,
            z_amplitude=1.0, n_dynamic=0,
            corridor=7.0 if small else 14.0,
        )
        beams = (synthetic.BeamModel(n_beams=32, n_azimuth=512) if small
                 else synthetic.BeamModel())
    scans = [
        synthetic.render_scan(world, t, np.random.default_rng(100 + t),
                              max_range=max_range, max_points=max_pts,
                              beams=beams)
        for t in range(n_frames)
    ]
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses

    for chunk in chunks:
        runner = OdometryRunner(base)
        warm = max(2, chunk and 2)
        for t in range(warm):
            runner.process_scan(scans[t], float(world.stamps[t]), sync=True)
        t = warm
        while t < n_frames:
            k = min(chunk, n_frames - t)
            if k > 1:
                runner.process_chunk(
                    scans[t : t + k],
                    [float(s) for s in world.stamps[t : t + k]],
                )
            else:
                runner.process_scan(scans[t], float(world.stamps[t]))
            t += k
        est = runner.trajectory()[: len(gt)]
        ate = evaluation.ate(est, gt[: len(est)], align=False)
        print(json.dumps({
            "chunk": chunk,
            "frames": n_frames,
            "ate_rmse_m": round(float(ate.rmse), 4),
            "ate_max_m": round(float(ate.max), 4),
            "keyframes": runner.num_keyframes(),
        }), flush=True)


if __name__ == "__main__":
    main()
