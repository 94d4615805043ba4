"""Measure the CPU reference baseline (cpp/dlo_baseline) on the exact bench world.

Renders the same synthetic sequence bench.py uses, dumps it to the baseline's
scan format, runs the from-scratch C++ DLO reproduction, and scores ATE with
the same evaluator — producing the measured denominator for BASELINE.md.

Usage: python cpp/run_baseline.py [--frames N] [--small] [--cv] [--threads N]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dump_scans(path: str, scans, stamps) -> None:
    with open(path, "wb") as f:
        f.write(b"DLOSCAN1")
        f.write(struct.pack("<q", len(scans)))
        for s, t in zip(scans, stamps):
            f.write(struct.pack("<d", float(t)))
            f.write(struct.pack("<q", len(s)))
            f.write(np.ascontiguousarray(s, np.float32).tobytes())


def load_traj(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<q", f.read(8))
        out = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            f.read(8)  # stamp
            out[i] = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cv", action="store_true")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--thin", type=int, default=0,
                    help="Morton-ordered uniform thinning of the voxeled "
                         "scan to N points — the same budget cap the JAX "
                         "pipeline applies (same-work protocol)")
    args = ap.parse_args()

    import bench
    from direct_lidar_odometry_tpu.io import evaluation, synthetic

    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = bench.make_bench_world(
        args.frames, rng, args.small)
    scans = [
        synthetic.render_scan(world, t, rng, max_range=max_range,
                              max_points=max_pts, beams=beams)
        for t in range(args.frames)
    ]
    print(f"# {len(scans)} scans, mean {np.mean([len(s) for s in scans]):.0f} pts",
          file=sys.stderr)

    exe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dlo_baseline")
    with tempfile.TemporaryDirectory() as d:
        sp, tp = os.path.join(d, "scans.bin"), os.path.join(d, "traj.bin")
        dump_scans(sp, scans, world.stamps)
        cmd = [exe]
        if args.cv:
            cmd.append("--cv")
        if args.threads:
            cmd += ["--threads", str(args.threads)]
        if args.thin:
            cmd += ["--thin", str(args.thin)]
        cmd += [sp, tp]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        for line in out.stderr.splitlines()[-3:]:
            print(line, file=sys.stderr)
        stats = json.loads(out.stdout.strip())
        est = load_traj(tp)

    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    ate = evaluation.ate(est.astype(np.float64), gt, align=False)
    stats["ate_rmse_m"] = round(float(ate.rmse), 4)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
