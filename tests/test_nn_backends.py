"""Neighbor-search backends: backend resolution, and every 1-NN path
against a float64 cKDTree on masked, empty and radius-edge targets."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

from direct_lidar_odometry_tpu.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu.ops import bruteforce, hashgrid


@pytest.mark.parametrize("nn_backend, want", [
    ("auto", "hashgrid"),
    ("hashgrid", "hashgrid"),
    ("brute", "brute"),
    ("triton", ValueError),
    ("kdtree", ValueError),
    ("pallas", ValueError),
    ("pallas_fused", ValueError),
    ("pallas_mxu", ValueError),
    ("pallas_unfused", ValueError),
])
def test_resolve_backend(nn_backend, want):
    cfg = DloConfig().replace(nn_backend=nn_backend)
    if want is ValueError:
        with pytest.raises(ValueError, match="nn_backend"):
            resolve_backend(cfg)
    else:
        assert resolve_backend(cfg) == want


def _problem(case: str, rng):
    """(targets [T,3], target mask [T], queries [Q,3], query mask [Q], r)."""
    r = 0.5
    t = rng.uniform(-5, 5, (700, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    tm = np.ones(len(t), bool)
    qm = rng.random(len(q)) > 0.1
    if case == "masked":
        tm = rng.random(len(t)) > 0.3
        # a masked-out point sitting exactly on some queries must never win
        t[:20] = q[:20]
        tm[:20] = False
    elif case == "empty":
        tm[:] = False
    elif case == "radius_edge":
        # each query has one target at exactly 0.98 r or 1.02 r
        q = q[:200]
        qm = qm[:200]
        d = rng.normal(size=(200, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        scale = np.where(np.arange(200) % 2 == 0, 0.98, 1.02) * r
        t = np.concatenate([q + d * scale[:, None], t[:500] + 40.0]).astype(np.float32)
        tm = np.ones(len(t), bool)
    return t, tm, q, qm, r


def _run(backend, t, tm, q, qm, r):
    args = (jnp.asarray(t), jnp.asarray(tm), jnp.asarray(q), jnp.asarray(qm))
    if backend == "brute":
        return bruteforce.query_1nn(*args, r, tile=len(t))
    grid = hashgrid.build(args[0], args[1], r, 2 ** 12)
    return hashgrid.query_1nn(grid, args[2], args[3], r, cap=64)


@pytest.mark.parametrize("case", ["masked", "empty", "radius_edge"])
@pytest.mark.parametrize("backend", ["hashgrid", "brute"])
def test_1nn_matches_kdtree(backend, case):
    rng = np.random.default_rng(7)
    t, tm, q, qm, r = _problem(case, rng)
    idx, d2, found = (np.asarray(x) for x in _run(backend, t, tm, q, qm, r))
    valid = np.flatnonzero(tm)
    want_found = np.zeros(len(q), bool)
    want_idx = np.full(len(q), -1)
    if len(valid):
        dd, ii = cKDTree(t[valid].astype(np.float64)).query(q.astype(np.float64))
        want_found = qm & (dd < r)
        want_idx = np.where(want_found, valid[ii], -1)
        np.testing.assert_allclose(d2[want_found], dd[want_found] ** 2,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(found, want_found)
    np.testing.assert_array_equal(idx, want_idx)
    assert not tm[idx[found]].size or tm[idx[found]].all()
