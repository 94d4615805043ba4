import json
import subprocess
import sys
import os

import numpy as np
import pytest


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""  # conftest's forcing doesn't reach subprocesses
    env["PYTHONPATH"] = REPO
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from direct_lidar_odometry_tpu.cli import main;"
        f"raise SystemExit(main({args!r}))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


SMALL = [
    "--set", "shapes.n_raw=8192", "--set", "shapes.n_scan=8192",
    "--set", "shapes.n_keyframe=8192", "--set", "shapes.max_keyframes=32",
    "--set", "shapes.max_submap_kf=4", "--set", "shapes.n_submap_flat=16384",
    "--set", "shapes.imu_window=64", "--set", "shapes.grid_table_size=16384",
    "--set", "shapes.submap_table_size=16384", "--set", "shapes.knn_query_chunk=2048",
    "--set", "shapes.hull_directions=16",
]


@pytest.mark.slow
def test_cli_synthetic_end_to_end(tmp_path):
    proc = run_cli(
        ["--synthetic", "10", "--out-dir", str(tmp_path), "--quiet", "--eval",
         "--map-ply", "map.ply", "--checkpoint", "ckpt.npz"] + SMALL,
        tmp_path,
    )
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 10
    assert summary["ate_rmse_m"] < 0.5  # synthetic world sized for bench, CPU small shapes
    # artifacts exist and parse
    from direct_lidar_odometry_tpu.io import ply, trajectory

    est = trajectory.read_kitti(str(tmp_path / "trajectory_kitti.txt"))
    assert est.shape == (10, 4, 4)
    m = ply.read_ply(str(tmp_path / "map.ply"))
    assert len(m) > 100
    assert (tmp_path / "ckpt.npz").exists()


@pytest.mark.slow
def test_cli_kitti_path_end_to_end(tmp_path):
    """Full --kitti path: synthetic loop world dumped in KITTI layout
    (sequences/<seq>/velodyne/*.bin + times.txt + poses/<seq>.txt), read
    back through kitti.load_sequence — and through the native C++
    prefetching feeder when cpp/libdlo_host.so is built — with ATE
    asserted against the dumped ground truth."""
    from direct_lidar_odometry_tpu.io import synthetic

    world = synthetic.make_loop_world(
        np.random.default_rng(2), n_frames=80, speed=0.4
    )
    root = synthetic.dump_kitti(
        world, str(tmp_path / "kitti"), "07",
        rng=np.random.default_rng(5), max_range=13.0, max_points=8192,
    )
    proc = run_cli(
        ["--kitti", root, "--sequence", "07", "--frames", "16",
         "--quiet", "--eval", "--out-dir", str(tmp_path)] + SMALL,
        tmp_path,
    )
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 16
    assert summary["ate_rmse_m"] < 0.15, summary
    from direct_lidar_odometry_tpu.io import native

    if native.available():
        assert "feeder" not in proc.stderr  # no native-feeder errors


def test_dump_kitti_roundtrip(tmp_path):
    """dump_kitti output parses with the production KITTI reader."""
    from direct_lidar_odometry_tpu.io import kitti, synthetic

    world = synthetic.make_loop_world(
        np.random.default_rng(0), n_frames=6, speed=0.4, z_amplitude=0.5
    )
    # elevation actually present in the ground truth
    z = world.poses[:, 2, 3]
    assert z.max() - z.min() > 0.1
    root = synthetic.dump_kitti(world, str(tmp_path), "11",
                                max_points=2048)
    seq = kitti.load_sequence(root, "11")
    assert len(seq) == 6
    assert seq.poses.shape == (6, 4, 4)
    np.testing.assert_allclose(seq.poses, world.poses, atol=1e-6)
    np.testing.assert_allclose(seq.stamps, world.stamps, atol=1e-6)
    s = seq.scan(2)
    assert s.shape[1] == 3 and 100 < len(s) <= 2048
    assert np.isfinite(s).all()
    # intensity channel present in the raw file
    raw = kitti.read_velodyne_bin(seq.files[2])
    assert raw.shape[1] == 4 and (raw[:, 3] > 0).all()


def test_checkpoint_roundtrip_api(tmp_path):
    import sys as _s
    _s.path.insert(0, "/root/repo/tests")
    from test_pipeline import tiny_cfg
    from direct_lidar_odometry_tpu.odometry import pipeline
    from direct_lidar_odometry_tpu.utils import checkpoint
    import jax

    cfg = tiny_cfg()
    state = pipeline.fresh_state(cfg)
    checkpoint.save_state(str(tmp_path / "s.npz"), state, extra={"prev_stamp": 1.5})
    restored, extra = checkpoint.load_state(str(tmp_path / "s.npz"), cfg)
    assert extra["prev_stamp"] == 1.5
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
