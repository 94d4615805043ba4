"""End-to-end test of the C++ CPU baseline (cpp/dlo_baseline).

The baseline is the measured reference denominator (BASELINE.md); this
test keeps it honest: it must build, run the dump format round-trip, and
track a synthetic world within tight ATE on the same evaluator used for
the JAX pipeline.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXE = os.path.join(REPO, "cpp", "dlo_baseline")


def _built() -> bool:
    if os.path.exists(EXE):
        return True
    if shutil.which("make") is None:
        return False
    r = subprocess.run(
        ["make", "-C", os.path.join(REPO, "cpp"), "dlo_baseline"],
        capture_output=True,
    )
    return r.returncode == 0 and os.path.exists(EXE)


pytestmark = pytest.mark.skipif(not _built(), reason="cpp toolchain unavailable")


def test_baseline_tracks_synthetic_world(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "cpp"))
    import run_baseline

    from direct_lidar_odometry_tpu.io import evaluation, synthetic

    rng = np.random.default_rng(3)
    world = synthetic.make_world(
        rng, n_frames=8, extent=15.0, n_boxes=6, speed=0.4,
        ground_points=8000, density=6.0,
    )
    scans = [
        synthetic.render_scan(world, t, rng, max_range=13.0, max_points=8192)
        for t in range(8)
    ]
    sp, tp = str(tmp_path / "scans.bin"), str(tmp_path / "traj.bin")
    run_baseline.dump_scans(sp, scans, world.stamps)
    out = subprocess.run(
        [EXE, sp, tp], capture_output=True, text=True, check=True, timeout=300
    )
    stats = json.loads(out.stdout.strip())
    assert stats["frames"] == 8
    est = run_baseline.load_traj(tp)
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses
    ate = evaluation.ate(est.astype(np.float64), gt, align=False)
    assert ate.rmse < 0.05, f"baseline diverged: ATE {ate.rmse:.3f} m"
