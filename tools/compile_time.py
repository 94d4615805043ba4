"""Where does the cold-start compile time go?

Measures trace (host) + XLA compile time of the production step program
and ablated variants, with the persistent cache disabled, to attribute the
first-frame compile and validate reductions. Run on the GPU:

    python tools/compile_time.py [variant ...]

Variants: full (bench program), norescue, gn, nocoarse, chunk8, init.
Default: full only (each costs minutes — pick deliberately).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(name: str, fn, args) -> None:
    import jax

    t0 = time.perf_counter()
    lowered = fn.lower(*args)
    t1 = time.perf_counter()
    lowered.compile()
    t2 = time.perf_counter()
    print(f"{name:12s} trace {t1-t0:7.1f} s   compile {t2-t1:7.1f} s", flush=True)


def abstract_args(cfg, chunk: int | None = None):
    import jax
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.odometry import pipeline

    sds = jax.ShapeDtypeStruct
    state_abs = jax.eval_shape(lambda: pipeline.fresh_state(cfg))
    cap = cfg.shapes.n_scan if cfg.host_preprocess else cfg.shapes.n_raw
    assert cfg.quantize_transfer
    wire = (
        sds((cap, 3), jnp.uint16), sds((3,), jnp.float32),
        sds((3,), jnp.float32), sds((), jnp.int32),
    )
    prior = sds((4, 4), jnp.float32)
    k = cfg.shapes.max_keyframes
    hull = (sds((k,), jnp.bool_), sds((k,), jnp.bool_), sds((), jnp.bool_))
    if chunk is not None:
        wire = tuple(sds((chunk,) + a.shape, a.dtype) for a in (*wire, prior))
        return (state_abs, *wire, *hull)
    return (state_abs, *wire, prior, *hull)


def main() -> None:
    import dataclasses

    import jax

    import bench
    from direct_lidar_odometry_tpu.odometry import pipeline

    # measure real compiles: no persistent-cache hits
    jax.config.update("jax_enable_compilation_cache", False)
    variants = sys.argv[1:] or ["full"]
    base = bench.production_cfg()

    for v in variants:
        cfg = base
        chunk = None
        if v == "norescue":
            cfg = base.replace(gicp=dataclasses.replace(base.gicp, s2m_rescue=False))
        elif v == "gn":
            cfg = base.replace(gicp=dataclasses.replace(
                base.gicp,
                s2s=dataclasses.replace(base.gicp.s2s, optimizer="gn"),
                s2m=dataclasses.replace(base.gicp.s2m, optimizer="gn"),
            ))
        elif v == "nocoarse":
            cfg = base.replace(gicp=dataclasses.replace(
                base.gicp, s2s_coarse_stride=1))
        elif v.startswith("chunk"):
            chunk = int(v[len("chunk"):])
        elif v == "init":
            init_fn, _ = pipeline.make_quantized_step_fns(cfg)
            measure("init", init_fn, abstract_args(cfg)[:5])
            continue
        elif v != "full":
            raise SystemExit(f"unknown variant {v}")
        if chunk is not None:
            fn = pipeline.make_chunked_step_fn(cfg)
            measure(v, fn, abstract_args(cfg, chunk=chunk))
        else:
            _, fn = pipeline.make_quantized_step_fns(cfg)
            measure(v, fn, abstract_args(cfg))


if __name__ == "__main__":
    main()
