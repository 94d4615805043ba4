import numpy as np
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import GicpStageConfig
from direct_lidar_odometry_tpu.core import cloud as cl, se3
from direct_lidar_odometry_tpu.ops import hashgrid
from direct_lidar_odometry_tpu.registration import covariance, gicp
from direct_lidar_odometry_tpu.io import synthetic

from tests.oracle import ref_gicp


def structured_cloud(rng, n=1500):
    """A scan-like structured cloud (ground + boxes) in the sensor frame."""
    world = synthetic.make_world(rng, n_frames=2, extent=25.0, n_boxes=12)
    pts = synthetic.render_scan(world, 0, rng, max_range=25.0, max_points=n)
    return pts.astype(np.float32)


def build_source_and_target(pts_src, pts_tgt, cap, radius, k=10):
    n = cap
    src_c = cl.from_numpy(pts_src, n)
    tgt_c = cl.from_numpy(pts_tgt, n)
    sn = covariance.estimate_normals_twoscale(src_c.points, src_c.mask, k=k, chunk=n)
    tn = covariance.estimate_normals_twoscale(tgt_c.points, tgt_c.mask, k=k, chunk=n)
    src = gicp.GicpSource(
        points=src_c.points, mask=src_c.mask, normals=sn.normals, normals_valid=sn.valid
    )
    target = gicp.make_target(
        tgt_c.points, tgt_c.mask, tn.normals, tn.valid, radius, 8192
    )
    return src, target


def test_gicp_recovers_known_transform(rng):
    pts = structured_cloud(rng)
    # known small SE(3) perturbation: target = T_true(source)
    w_true = np.array([0.02, -0.03, 0.05], np.float32)
    t_true = np.array([0.3, -0.2, 0.1], np.float32)
    T_true = np.asarray(se3.make_se3(se3.so3_exp(jnp.asarray(w_true)), jnp.asarray(t_true)))
    pts_tgt = pts @ T_true[:3, :3].T + T_true[:3, 3]
    pts_tgt += rng.normal(scale=0.005, size=pts_tgt.shape).astype(np.float32)

    cfg = GicpStageConfig(max_correspondence_distance=1.0, max_iterations=32)
    src, target = build_source_and_target(pts, pts_tgt, 2048, 1.0)
    res = gicp.align(src, target, jnp.eye(4), cfg, cap=32)
    T_est = np.asarray(res.transform)
    err_t = np.linalg.norm(T_est[:3, 3] - T_true[:3, 3])
    err_r = np.degrees(
        np.arccos(np.clip((np.trace(T_est[:3, :3] @ T_true[:3, :3].T) - 1) / 2, -1, 1))
    )
    assert bool(res.converged), f"not converged after {int(res.iterations)} iters"
    assert err_t < 0.03, err_t
    assert err_r < 0.3, err_r
    assert int(res.num_correspondences) > 1000


def test_gicp_gn_mode(rng):
    pts = structured_cloud(rng, n=1200)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0.2, 0.1, -0.05]
    pts_tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)

    cfg = GicpStageConfig(optimizer="gn", max_iterations=32)
    src, target = build_source_and_target(pts, pts_tgt, 2048, 1.0)
    res = gicp.align(src, target, jnp.eye(4), cfg, cap=32)
    T_est = np.asarray(res.transform)
    assert np.linalg.norm(T_est[:3, 3] - T_true[:3, 3]) < 0.02


def test_gicp_matches_oracle(rng):
    """The f32 JAX result should land close to the f64 oracle's pose."""
    pts = structured_cloud(rng, n=1000)
    w_true = np.array([0.0, 0.0, 0.04], np.float32)
    t_true = np.array([0.4, -0.1, 0.0], np.float32)
    T_true = np.asarray(se3.make_se3(se3.so3_exp(jnp.asarray(w_true)), jnp.asarray(t_true)))
    pts_tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)

    # oracle with full covariances (normals-equivalent under PLANE)
    o = ref_gicp.OracleGICP(max_corr_dist=1.0)
    o.set_target(pts_tgt, ref_gicp.plane_covariances(pts_tgt, k=10))
    o.set_source(pts, ref_gicp.plane_covariances(pts, k=10))
    T_oracle = o.align(np.eye(4))

    cfg = GicpStageConfig(max_correspondence_distance=1.0)
    src, target = build_source_and_target(pts, pts_tgt, 1024, 1.0)
    res = gicp.align(src, target, jnp.eye(4), cfg, cap=32)
    T_est = np.asarray(res.transform)

    # both should be near T_true; mutual distance small
    assert np.linalg.norm(T_oracle[:3, 3] - T_true[:3, 3]) < 0.02
    assert np.linalg.norm(T_est[:3, 3] - T_oracle[:3, 3]) < 0.03
    dr = T_est[:3, :3] @ T_oracle[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))) < 0.3


def test_gicp_guess_initialization(rng):
    """A good guess (IMU prior role) must be exploited: large rotation case."""
    pts = structured_cloud(rng, n=1500)
    w_true = np.array([0.0, 0.0, 0.35], np.float32)  # ~20 deg yaw
    T_true = np.asarray(se3.make_se3(se3.so3_exp(jnp.asarray(w_true)), jnp.zeros(3)))
    pts_tgt = (pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)

    cfg = GicpStageConfig(max_correspondence_distance=1.0)
    src, target = build_source_and_target(pts, pts_tgt, 2048, 1.0)
    guess = jnp.asarray(
        np.asarray(se3.make_se3(se3.so3_exp(jnp.asarray([0.0, 0.0, 0.32])), jnp.zeros(3)))
    )
    res = gicp.align(src, target, guess, cfg, cap=32)
    T_est = np.asarray(res.transform)
    dr = T_est[:3, :3] @ T_true[:3, :3].T
    assert np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))) < 0.5


def test_compute_error_matches_direct():
    """_compute_error's columnwise Mahalanobis == explicit 3x3 math."""
    from direct_lidar_odometry_tpu.config import load_config
    from direct_lidar_odometry_tpu.registration.covariance import PLANE_EPS

    rng = np.random.default_rng(1)
    # targets on a jittered grid, sources near them with random normals
    nt, ns = 1024, 512
    gx, gy = np.meshgrid(np.arange(32), np.arange(32))
    base = np.stack([gx.ravel(), gy.ravel()], axis=1)[:nt] * 1.0
    tgt = np.concatenate([base + rng.uniform(-0.3, 0.3, base.shape),
                          rng.uniform(0, 2.0, (nt, 1))], axis=1).astype(np.float32)
    tnorm = rng.normal(size=(nt, 3)).astype(np.float32)
    tnorm /= np.linalg.norm(tnorm, axis=1, keepdims=True)
    src = tgt[rng.choice(nt, ns)] + rng.normal(0, 0.05, (ns, 3)).astype(np.float32)
    snorm = rng.normal(size=(ns, 3)).astype(np.float32)
    snorm /= np.linalg.norm(snorm, axis=1, keepdims=True)
    target = gicp.make_target(jnp.asarray(tgt), jnp.ones(nt, bool),
                              jnp.asarray(tnorm), jnp.asarray(rng.random(nt) > 0.1),
                              0.5, 4096, backend="brute")
    source = gicp.GicpSource(points=jnp.asarray(src), mask=jnp.ones(ns, bool),
                             normals=jnp.asarray(snorm),
                             normals_valid=jnp.asarray(rng.random(ns) > 0.1))
    cfg = load_config().gicp.s2m
    x0 = jnp.eye(4, dtype=jnp.float32)
    lin = gicp._linearize(x0, source, target, cfg, 32, "brute")
    assert int(lin.n_corr) > 200

    xi = se3.se3_exp(jnp.asarray([0.01, 0.0, -0.01, 0.02, 0.01, 0.0],
                                 jnp.float32))
    got = float(gicp._compute_error(xi, source, lin))

    # oracle: explicit per-point 3x3 inverse
    p_t = np.asarray(se3.transform_points(xi, source.points), np.float64)
    mu_b = np.asarray(lin.mu_b, np.float64)
    n_b = np.asarray(lin.n_b, np.float64)
    m0 = np.asarray(lin.m0, np.float64)
    w = np.asarray(lin.weight, np.float64)
    want = 0.0
    a = 1.0 - PLANE_EPS
    for i in range(len(w)):
        if w[i] < 0.5:
            continue
        A = 2 * np.eye(3) - a * (np.outer(n_b[i], n_b[i]) + np.outer(m0[i], m0[i]))
        e = mu_b[i] - p_t[i]
        want += e @ np.linalg.inv(A) @ e
    np.testing.assert_allclose(got, want, rtol=1e-4)
