"""Every matrix product the jitted entry points lower runs at HIGHEST
precision (full float32; no TF32 on a GPU) — see utils/precision.py."""

import re
from functools import partial

import jax
import jax.numpy as jnp
import pytest

from direct_lidar_odometry_tpu.odometry import pipeline
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

from tests.test_pipeline import tiny_cfg


def _abstract_args(cfg, chunk=None):
    sds = jax.ShapeDtypeStruct
    state = jax.eval_shape(partial(pipeline.fresh_state, cfg))
    cap = cfg.shapes.n_raw
    wire = (sds((cap, 3), jnp.uint16), sds((3,), jnp.float32),
            sds((3,), jnp.float32), sds((), jnp.int32))
    prior = sds((4, 4), jnp.float32)
    k = cfg.shapes.max_keyframes
    hull = (sds((k,), jnp.bool_), sds((k,), jnp.bool_), sds((), jnp.bool_))
    if chunk:
        stacked = tuple(sds((chunk,) + a.shape, a.dtype) for a in (*wire, prior))
        return (state, *stacked, *hull)
    return (state, *wire, prior, *hull)


def _lowered(program):
    cfg = tiny_cfg()
    if program == "step":
        fn = OdometryRunner(cfg).step_fn
        return fn.lower(*_abstract_args(cfg))
    if program == "chunked_step":
        fn = pipeline.make_chunked_step_fn(cfg)
        return fn.lower(*_abstract_args(cfg, chunk=2))
    runner = OdometryRunner(cfg.replace(
        posegraph=cfg.posegraph.__class__(use=True)))
    state = jax.eval_shape(partial(pipeline.fresh_state, runner.cfg))
    return runner.refine_fn().lower(state)


@pytest.mark.parametrize("program", ["step", "chunked_step", "refine"])
def test_every_dot_general_is_highest(program):
    text = _lowered(program).as_text()
    dots = [l for l in text.splitlines() if "stablehlo.dot_general" in l]
    assert dots, "no matrix products found"
    bad = [l.strip() for l in dots
           if not re.search(r"precision = \[HIGHEST, HIGHEST\]", l)]
    assert not bad, bad[:3]
