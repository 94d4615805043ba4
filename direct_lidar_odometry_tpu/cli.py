"""Command-line runner — the process entry point.

Replaces the reference's ROS launch graph (``launch/dlo.launch`` starting
``dlo_odom_node`` + ``dlo_map_node`` + RViz) with one offline/online
process: read scans (KITTI dir or synthetic), run the jitted pipeline,
print the live dashboard, write trajectory (KITTI/TUM), export the map
(PLY/NPZ), optionally checkpoint/resume.

Usage examples:
    python -m direct_lidar_odometry_tpu --synthetic 100 --out-dir /tmp/run
    python -m direct_lidar_odometry_tpu --kitti /data/kitti --sequence 00 \
        --config cfg/dlo.yaml --map-ply map.ply --eval
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("direct_lidar_odometry_tpu")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti", help="KITTI odometry dataset root")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run N synthetic frames (no dataset needed)")
    ap.add_argument("--sequence", default="00", help="KITTI sequence id")
    ap.add_argument("--config", help="YAML config (see cfg/dlo.yaml)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="dotted config override, e.g. gicp.s2s.max_iterations=16")
    ap.add_argument("--frames", type=int, default=None, help="limit frame count")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--traj-kitti", default="trajectory_kitti.txt")
    ap.add_argument("--traj-tum", default="trajectory_tum.txt")
    ap.add_argument("--map-ply", default=None, help="export map as PLY")
    ap.add_argument("--map-live", action="store_true",
                    help="with --map-ply: additionally re-export the map "
                         "every 1/map.publish_freq seconds of DATA time "
                         "during the run — the in-process analog of the "
                         "reference's periodically published map topic "
                         "(map.cc:100-131). NB map.publish_freq is in Hz "
                         "here; the reference quirkily passes its "
                         "publish_freq param as a timer PERIOD in seconds "
                         "(map.cc:24,51), so the two only coincide at the "
                         "1.0 default. Each export synchronizes the "
                         "pipeline and rebuilds the map, so it costs "
                         "throughput; the final map is written either way.")
    ap.add_argument("--checkpoint", default=None, help="save state here at exit")
    ap.add_argument("--resume", default=None, help="restore state from checkpoint")
    ap.add_argument("--eval", action="store_true",
                    help="report ATE/RPE against ground truth if available")
    ap.add_argument("--quiet", action="store_true", help="no per-frame dashboard")
    ap.add_argument("--dashboard-every", type=int, default=10)
    return ap


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return key, val.lower() == "true"
    return key, val


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from direct_lidar_odometry_tpu.config import load_config
    from direct_lidar_odometry_tpu.io import evaluation, kitti, ply, synthetic, trajectory
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu.utils import checkpoint, profiling

    cfg = load_config(args.config, dict(_parse_override(s) for s in args.set))
    runner = OdometryRunner(cfg)
    timing = profiling.TimingStats()
    cpu_mon = profiling.CpuMonitor()  # CPU load/cores (odom.cc:1386-1403)

    # graceful shutdown: finish the frame, write outputs (the reference's
    # SIGTERM -> abort timer -> stop() analog, odom_node.cc:12-16)
    stop = {"flag": False}
    signal.signal(signal.SIGINT, lambda *_: stop.__setitem__("flag", True))
    signal.signal(signal.SIGTERM, lambda *_: stop.__setitem__("flag", True))

    # --- frame source ---------------------------------------------------
    gt_poses = None
    if args.kitti:
        from direct_lidar_odometry_tpu.io import native

        seq = kitti.load_sequence(args.kitti, args.sequence)
        n_frames = min(len(seq), args.frames or len(seq))
        gt_poses = seq.poses

        if cfg.map.carry_intensity:
            # PointXYZI parity: feed 4-column scans so the runner's
            # intensity sidecar can mirror keyframes (map export keeps
            # intensity; the odometry itself never reads it)
            def frames():
                for i in range(n_frames):
                    yield seq.scan_xyzi(i), float(seq.stamps[i])
        elif native.available():
            # native background prefetcher: raw reads only — the device
            # pipeline does its own preprocessing (res=0 disables native
            # voxelization to keep one canonical preprocessing path)
            def frames():
                feeder = native.ScanFeeder(
                    seq.files[:n_frames], cap=cfg.shapes.n_raw,
                    crop_size=0.0, res=0.0,
                )
                try:
                    for i, scan in feeder:
                        yield scan, float(seq.stamps[i])
                finally:
                    feeder.close()
        else:
            def frames():
                for i in range(n_frames):
                    yield seq.scan(i), float(seq.stamps[i])
    else:
        rng = np.random.default_rng(0)
        n_frames = args.frames or args.synthetic
        # ray-cast campus world (round 5): exact occlusion + OS1-64 beam
        # model — the same realism class the bench and the C++ baseline
        # run on. Beam resolution scales with the raw-scan capacity.
        if cfg.shapes.n_raw >= 65536:
            world = synthetic.make_urban_world(rng, n_frames=n_frames,
                                               speed=1.0, n_dynamic=2)
            beams = synthetic.BeamModel()
            max_range = 40.0
        else:
            world = synthetic.make_urban_world(
                rng, n_frames=n_frames, speed=0.4, corridor=7.0, n_dynamic=1)
            beams = synthetic.BeamModel(n_beams=32, n_azimuth=512)
            max_range = 13.0
        gt_poses = world.poses

        def frames():
            for i in range(n_frames):
                yield (
                    synthetic.render_scan(world, i, rng, max_range=max_range,
                                          max_points=cfg.shapes.n_raw,
                                          beams=beams),
                    float(world.stamps[i]),
                )

    if args.resume:
        runner.state, extra = checkpoint.load_state(args.resume, cfg)
        runner.prev_stamp = extra.get("prev_stamp")
        print(f"resumed from {args.resume}", file=sys.stderr)

    # --- main loop --------------------------------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    distance = 0.0
    last_pos = None
    next_map_stamp = None  # --map-live schedule (cfg.map.publish_freq Hz)
    for i, (scan, stamp) in enumerate(frames()):
        if stop["flag"]:
            print("interrupted — writing outputs", file=sys.stderr)
            break
        res = runner.process_scan(scan, stamp)
        if (args.map_live and args.map_ply and cfg.map.publish_freq > 0
                and runner.state is not None):
            if next_map_stamp is None:
                next_map_stamp = stamp + 1.0 / cfg.map.publish_freq
            elif stamp >= next_map_stamp:
                m_live = runner.build_map()
                ply.write_ply(os.path.join(args.out_dir, args.map_ply), m_live)
                print(f"[map] frame {i}: {len(m_live)} points -> "
                      f"{args.map_ply}", file=sys.stderr)
                next_map_stamp = stamp + 1.0 / cfg.map.publish_freq
        timing.push(runner.stats[-1].wall_ms if runner.stats else 0.0)
        if not args.quiet:
            # distance tracking reads the pose (device sync); quiet runs
            # compute it once from the trajectory at the end instead
            pos = np.asarray(runner.state.pose)[:3, 3]
            if last_pos is not None:
                distance += float(np.linalg.norm(pos - last_pos))
            last_pos = pos
        if not args.quiet and res is not None:
            # health runs EVERY frame (a divergence inside the dashboard
            # window must not be missed); --quiet skips both so quiet runs
            # stay fully async — these reads force a device sync
            status = runner.health_check(res)
            if status != "ok":
                print(
                    f"[health] frame {i}: {status} "
                    f"(s2s_corr={int(res.s2s_num_corr)} "
                    f"s2m_corr={int(res.s2m_num_corr)} "
                    f"s2s_converged={bool(res.s2s_converged)})"
                    + (" — restart from --checkpoint to recover"
                       if status == "diverged" else ""),
                    file=sys.stderr,
                )
            if i % args.dashboard_every == 0:
                quat = np.asarray(res.quat)
                health = {
                    "s2s_it": int(res.s2s_iterations), "s2s_nc": int(res.s2s_num_corr),
                    "s2m_it": int(res.s2m_iterations), "s2m_nc": int(res.s2m_num_corr),
                }
                print(profiling.dashboard(i, pos, quat, distance, timing,
                                          int(res.num_keyframes), health,
                                          cpu=cpu_mon))

    # --- outputs ----------------------------------------------------------
    est = runner.trajectory()
    if args.quiet and len(est) > 1:
        distance = float(np.sum(np.linalg.norm(np.diff(est[:, :3, 3], axis=0), axis=-1)))
    trajectory.write_kitti(os.path.join(args.out_dir, args.traj_kitti), est)
    trajectory.write_tum(
        os.path.join(args.out_dir, args.traj_tum),
        np.asarray(runner.stamps), est,
    )
    if args.map_ply and runner.state is not None:
        if cfg.map.carry_intensity and runner._ikf:
            m = runner.build_map_xyzi()  # [P, 4] xyzi
        else:
            m = runner.build_map()
        ply.write_ply(os.path.join(args.out_dir, args.map_ply), m)
        print(f"map: {len(m)} points -> {args.map_ply}", file=sys.stderr)
    if args.checkpoint and runner.state is not None:
        checkpoint.save_state(
            os.path.join(args.out_dir, args.checkpoint), runner.state,
            extra={"prev_stamp": runner.prev_stamp},
        )

    summary = {
        "frames": len(est),
        "keyframes": runner.num_keyframes(),
        "distance_m": round(distance, 2),
        **{k: round(v, 2) for k, v in timing.steady_state().items()},
    }
    if runner.cfg.posegraph.use:
        summary.update(
            refine_rounds=len(runner.refine_log),
            loop_edges_accepted=sum(
                e["n_accepted"] for e in runner.refine_log
            ),
        )
    if args.eval and gt_poses is not None and len(est) > 1:
        gt_rel = np.linalg.inv(gt_poses[0])[None] @ gt_poses[: len(est)]
        ate = evaluation.ate(est, gt_rel, align=False)
        rpe_t, rpe_r = evaluation.rpe(est, gt_rel)
        summary.update(
            ate_rmse_m=round(ate.rmse, 4), ate_max_m=round(ate.max, 4),
            rpe_trans_m=round(rpe_t, 4), rpe_rot_deg=round(rpe_r, 4),
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
