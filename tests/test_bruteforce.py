import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial import cKDTree

from direct_lidar_odometry_tpu.ops import bruteforce
from direct_lidar_odometry_tpu.registration import covariance


@pytest.mark.parametrize("tile", [256, 384])  # 384: a padded partial tile
def test_brute_1nn_matches_kdtree(rng, tile):
    tgt = rng.uniform(-10, 10, size=(1024, 3)).astype(np.float32)
    qry = (tgt[:512] + rng.normal(scale=0.3, size=(512, 3))).astype(np.float32)
    tmask = np.ones(1024, bool)
    tmask[900:] = False
    idx, d2, found = bruteforce.query_1nn(
        jnp.asarray(tgt), jnp.asarray(tmask), jnp.asarray(qry),
        jnp.ones(512, bool), radius=1.0, tile=tile,
    )
    tree = cKDTree(tgt[:900])
    dref, iref = tree.query(qry, k=1)
    idx, found, d2 = np.asarray(idx), np.asarray(found), np.asarray(d2)
    in_r = dref < 1.0
    np.testing.assert_array_equal(found, in_r)
    np.testing.assert_array_equal(idx[in_r], iref[in_r])
    np.testing.assert_allclose(np.sqrt(d2[in_r]), dref[in_r], rtol=1e-4)
    assert np.all(idx[~in_r] == -1)


def test_brute_1nn_respects_query_mask(rng):
    tgt = rng.uniform(-5, 5, size=(256, 3)).astype(np.float32)
    qmask = np.zeros(256, bool)
    qmask[:100] = True
    idx, _, found = bruteforce.query_1nn(
        jnp.asarray(tgt), jnp.ones(256, bool), jnp.asarray(tgt),
        jnp.asarray(qmask), radius=1.0, tile=256,
    )
    found = np.asarray(found)
    assert found[:100].all() and not found[100:].any()
    np.testing.assert_array_equal(np.asarray(idx)[:100], np.arange(100))


def test_brute_knn_matches_kdtree(rng):
    pts = rng.uniform(-6, 6, size=(512, 3)).astype(np.float32)
    k = 10
    idx, d2, valid = bruteforce.query_knn(
        jnp.asarray(pts), jnp.ones(512, bool), jnp.asarray(pts),
        jnp.ones(512, bool), k=k, chunk=128,
    )
    tree = cKDTree(pts)
    dref, iref = tree.query(pts, k=k)
    idx = np.asarray(idx)
    assert np.asarray(valid).all()
    same = [set(idx[i]) == set(iref[i]) for i in range(512)]
    assert np.mean(same) == 1.0  # exact, unbounded — no ties expected here
    np.testing.assert_allclose(
        np.sort(np.sqrt(np.asarray(d2)), axis=1), np.sort(dref, axis=1), rtol=1e-3
    )


def test_brute_normals_match_twoscale_quality(rng):
    """Brute normals are at least as accurate as the two-scale hash-grid
    ones on a plane-dominated cloud."""
    n = np.array([0.3, -0.5, 0.8]); n /= np.linalg.norm(n)
    basis = np.linalg.svd(n[None])[2][1:]
    uv = rng.uniform(-5, 5, size=(1024, 2))
    pts = (uv @ basis + rng.normal(scale=0.01, size=(1024, 3))).astype(np.float32)
    nrm = covariance.estimate_normals_brute(
        jnp.asarray(pts), jnp.ones(1024, bool), k=10, chunk=256
    )
    dots = np.abs(np.asarray(nrm.normals) @ n)
    assert np.asarray(nrm.valid).all()
    assert (dots > 0.995).mean() > 0.99
    assert np.median(dots) > 0.9995


def test_pipeline_brute_backend_tracks(rng):
    """Full pipeline on the brute backend (CPU) must track like hashgrid."""
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline import SCAN_RANGE, make_test_world, tiny_cfg
    from direct_lidar_odometry_tpu.io import evaluation, synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    cfg = tiny_cfg().replace(nn_backend="brute")
    world = make_test_world(7, n_frames=8)
    runner = OdometryRunner(cfg)
    srng = np.random.default_rng(3)
    for t in range(8):
        scan = synthetic.render_scan(world, t, srng, max_range=SCAN_RANGE, max_points=8192)
        runner.process_scan(scan, world.stamps[t])
    est = runner.trajectory()
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[: len(est)]
    res = evaluation.ate(est, gt, align=False)
    assert res.rmse < 0.05, res
