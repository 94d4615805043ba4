"""Intensity channel parity (reference pcl::PointXYZI, dlo/dlo.h:50).

The reference carries intensity end-to-end through every PCL filter; the
JAX framework keeps it OFF the device hot path (it is algorithmically
unused in the reference too) and instead mirrors keyframe scans host-side
(runner intensity sidecar) so map export preserves a per-point intensity:
KITTI xyzi in -> odometry -> PLY xyzi map out.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_pipeline import SCAN_RANGE, make_test_world, tiny_cfg

from direct_lidar_odometry_tpu.io import hostprep, kitti, ply, synthetic
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner


def _world_intensity(world_pts: np.ndarray) -> np.ndarray:
    """Smooth synthetic reflectivity field over world coordinates."""
    return (
        0.5
        + 0.3 * np.sin(0.31 * world_pts[:, 0])
        + 0.15 * np.cos(0.23 * world_pts[:, 1])
    ).astype(np.float32)


def test_voxel_mean_xyzi_oracle():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, size=(500, 1)).astype(np.float32)
    res = 0.5
    out = hostprep.voxel_mean_xyzi(np.concatenate([pts, inten], axis=1), res)
    # oracle: group by integer voxel coordinate, average all four channels
    origin = pts.min(axis=0)
    keys = np.floor((pts - origin) / res).astype(np.int64)
    groups: dict[tuple, list[int]] = {}
    for i, k in enumerate(map(tuple, keys)):
        groups.setdefault(k, []).append(i)
    assert len(out) == len(groups)
    want = sorted(
        np.concatenate([pts[ix], inten[ix]], axis=1).mean(axis=0).tolist()
        for ix in groups.values()
    )
    got = sorted(out.tolist())
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_intensity_survives_to_map(tmp_path):
    cfg = tiny_cfg()
    cfg = dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, carry_intensity=True)
    )
    n = 20
    world = make_test_world(7, n_frames=n)
    r = OdometryRunner(cfg)
    for t in range(n):
        s = synthetic.render_scan(
            world, t, np.random.default_rng(1000 + t),
            max_range=SCAN_RANGE, max_points=cfg.shapes.n_raw,
        )
        # intensity is a world-frame material property; scans are
        # sensor-frame, so evaluate the field at the world position
        w = s @ world.poses[t][:3, :3].T + world.poses[t][:3, 3]
        xyzi = np.concatenate([s, _world_intensity(w)[:, None]], axis=1)
        r.process_scan(xyzi, stamp=float(world.stamps[t]))
    assert r.num_keyframes() >= 2
    m = r.build_map_xyzi()
    assert m.shape[1] == 4 and len(m) > 100
    # trajectory is cm-accurate and the field is smooth, so the mapped
    # intensity must reproduce the field at each map point's world position
    origin_adj = world.poses[0]  # runner trajectory starts at identity
    world_xyz = m[:, :3] @ origin_adj[:3, :3].T + origin_adj[:3, 3]
    err = np.abs(m[:, 3] - _world_intensity(world_xyz))
    assert float(np.mean(err)) < 0.05, float(np.mean(err))

    # PLY roundtrip keeps the channel
    path = str(tmp_path / "map.ply")
    ply.write_ply(path, m)
    back = ply.read_ply(path)
    assert back.shape == m.shape
    np.testing.assert_allclose(back, m, atol=0)


def test_kitti_xyzi_roundtrip(tmp_path):
    vdir = tmp_path / "sequences" / "00" / "velodyne"
    os.makedirs(vdir)
    rng = np.random.default_rng(3)
    scan = rng.uniform(-10, 10, size=(256, 4)).astype(np.float32)
    scan[:, 3] = rng.uniform(0, 1, size=256)
    scan.tofile(str(vdir / "000000.bin"))
    seq = kitti.KittiSequence(velodyne_dir=str(vdir))
    got = seq.scan_xyzi(0)
    np.testing.assert_array_equal(got, scan)
    assert seq.scan(0).shape == (256, 3)
