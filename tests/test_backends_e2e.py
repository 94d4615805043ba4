"""End-to-end pipeline on each plain backend at tiny shapes: per-frame
and chunked (lax.scan) dispatch must agree and track ground truth — the
program composition bench.py runs, exercised on the CPU."""

import numpy as np
import pytest

from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu.io import evaluation, synthetic
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

SCAN_RANGE = 13.0


def small_cfg(backend: str) -> DloConfig:
    return DloConfig().replace(
        nn_backend=backend,
        shapes=ShapeConfig(
            n_raw=4096, n_scan=2048, n_keyframe=1024, max_keyframes=16,
            max_submap_kf=4, n_submap_flat=4096, imu_window=32,
            grid_table_size=2 ** 12, submap_table_size=2 ** 12,
            cell_cap_1nn=8, cell_cap_knn=32, knn_query_chunk=1024,
            hull_directions=16,
        ),
    )


@pytest.fixture(scope="module")
def sparse_world():
    # sparse enough that scans fit the 2048-point budget
    rng = np.random.default_rng(0)
    return synthetic.make_world(
        rng, n_frames=10, extent=15.0, n_boxes=6, speed=0.4,
        ground_points=3000, density=3.0,
    )


def _ate(runner, world):
    est = runner.trajectory()
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    return evaluation.ate(est, gt, align=False).rmse


@pytest.mark.parametrize("backend", ["hashgrid", "brute"])
def test_chunked_matches_per_frame(sparse_world, backend):
    cfg = small_cfg(backend)
    scans = [
        synthetic.render_scan(sparse_world, t, np.random.default_rng(50 + t),
                              max_range=SCAN_RANGE, max_points=4096)
        for t in range(6)
    ]
    stamps = [float(s) for s in sparse_world.stamps[:6]]

    single = OdometryRunner(cfg)
    for s, st in zip(scans, stamps):
        single.process_scan(s, st, sync=True)
    for st in single.stats[1:]:
        assert int(st.result.s2m_num_corr) > 100

    chunked = OdometryRunner(cfg)
    chunked.process_scan(scans[0], stamps[0])  # init frame
    chunked.process_scan(scans[1], stamps[1])
    chunked.process_chunk(scans[2:6], stamps[2:6])

    est_a, est_b = single.trajectory(), chunked.trajectory()
    assert est_a.shape == est_b.shape == (6, 4, 4)
    np.testing.assert_allclose(est_a, est_b, atol=5e-3)
    assert _ate(single, sparse_world) < 0.05
    assert _ate(chunked, sparse_world) < 0.05
