"""Run the odometry main path once on a GPU and check what comes out.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: only the sharded path

Phases (one card), in order; any failure exits non-zero with no ok line:

- device: refuse anything but a GPU; print the JAX version, the device,
  the card's name and power limit (nvidia-smi), XLA_FLAGS, the compile
  cache, and whether host preprocessing runs native or in numpy.
- kernels: at the bench widths (12288 queries against 12288 scan targets
  and 16384 submap targets, masked padding), every neighbor-search path
  against the plain reference (ops/bruteforce.query_1nn on the card) and a
  float64 host cKDTree; kNN normals against a float64 plane fit over the
  same neighbors. Matmul precision HIGHEST.
- pipeline: the bench operating point (bench.production_cfg, an OS1-64
  class ray-cast world) through OdometryRunner: 5 frames per-frame, then
  chunks of 8. ATE gate; chunked vs per-frame poses; memory and compile
  figures.
- loopclosure: bench._loop_closure_check (dense pose-graph refine);
  keyframe-map error must fall.

``--devices 4`` runs only parallel/sharded.make_sharded_step (four seeded
sequences, one lane per card) against parallel/batched on one card, and
make_distributed_refine on an ``edge`` mesh against posegraph.refine.

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FRAMES = 45          # 5 per-frame + 5 chunks of 8
WARMUP = 5
CHUNK = 8
# d2 tolerance (1e-5 relative + 1e-6 m^2) and the near-tie gap (1e-5
# relative) under which two target indices count as equally near
D2_RTOL, D2_ATOL, TIE_RTOL = 1e-5, 1e-6, 1e-5
# On queries next to a cell of more than cell_cap_1nn targets the hash grid
# gathers only cell_cap_1nn candidates of that cell, so it may return a
# farther neighbor or none. There its results must still be sound, and the
# share of queries whose answer differs from the exact nearest stays under
# this bound (measured on an H100: 261 of 2936 such queries, 8.9%, at the
# S2S radius of the bench operating point).
CAPPED_MISS_MAX = 0.12
# normals: |cos| against a float64 plane fit over the same neighbors
COS_MIN = 0.999
# chunked vs per-frame stepping: on a GPU, scatter-add order and the
# reductions XLA autotunes per program can differ between the per-frame
# and the chunked (lax.scan) executables, so their poses agree to a
# tolerance rather than bit for bit
POSE_ATOL_M = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}] {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, phase: str, msg: str) -> None:
    if not cond:
        fail(phase, msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn, *args, reps: int = 20) -> float:
    """Median device ms of ``fn(*args)`` (compiled and warmed first)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# --------------------------------------------------------------------- device
def phase_device(card: str) -> dict:
    import jax

    from direct_lidar_odometry_tpu.io import native
    from direct_lidar_odometry_tpu.utils import cachedir

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"# jax {jax.__version__}  device {dev.device_kind} x{info['count']}")
    log(f"# card: {card}")
    log(f"# XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"# compile cache: {cachedir.cache_dir()}")
    log(f"# host preprocessing: "
        f"{'native (cpp/libdlo_host.so)' if native.available() else 'numpy'}")
    return info


# -------------------------------------------------------------------- kernels
def bench_clouds(n_scan: int, n_sub: int, seed: int = 0):
    """Real bench-width clouds: (queries, scan targets, submap targets),
    each as padded (points [N,3] f32, mask [N]) numpy pairs."""
    import bench
    from direct_lidar_odometry_tpu.io import hostprep, synthetic

    rng = np.random.default_rng(seed)
    world, max_range, max_pts, beams = bench.make_bench_world(8, rng, False)
    scans = [synthetic.render_scan(world, t, rng, max_range=max_range,
                                   max_points=max_pts, beams=beams)
             for t in range(4)]

    def pad(p, n):
        out = np.full((n, 3), 1e6, np.float32)
        m = np.zeros(n, bool)
        k = min(len(p), n)
        out[:k], m[:k] = p[:k], True
        return out, m

    def prep(s, res, cap):
        return hostprep.preprocess_morton(s, 1.0, res, cap)

    # queries: scan 1 seen from a slightly wrong pose (a GICP iterate)
    q = prep(scans[1], 0.25, n_scan)
    ang = 0.01
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                    [0, 0, 1]], np.float32)
    q = q @ rot.T + np.array([0.05, -0.03, 0.01], np.float32)
    scan_t = prep(scans[0], 0.25, n_scan)
    # submap: frames 0, 2, 3 voxeled at the submap resolution, pruned to
    # the n_submap_flat points nearest the sensor like submap assembly
    sub = np.concatenate([prep(scans[i], 0.5, n_sub) for i in (0, 2, 3)])
    sub = sub[np.argsort(np.sum(sub ** 2, axis=1))[:n_sub - 1000]]
    return pad(q, n_scan), pad(scan_t, n_scan), pad(sub, n_sub)


def compare_1nn(d2, found, ref_d2_f64, radius, exact):
    """Count one path's found-flag and d2 mismatches against float64 truth.

    ``ref_d2_f64``: exact nearest d2 per query (inf where no valid target);
    ``exact``: queries on which the path is exact by design (all but the
    hash grid's capped-cell queries). Returns (bad found, bad d2, queries
    found by both).
    """
    r2 = radius * radius
    tol = D2_RTOL * ref_d2_f64 + D2_ATOL
    in_r = ref_d2_f64 < r2
    clear = np.abs(ref_d2_f64 - r2) > tol  # not on the radius boundary
    sel = exact & clear
    bad_found = np.sum((found != in_r) & sel)
    both = found & in_r & exact
    d2_err = np.abs(d2[both].astype(np.float64) - ref_d2_f64[both])
    bad_d2 = np.sum(d2_err > tol[both])
    return bad_found, bad_d2, both


def unsound_1nn(idx, d2, found, t, tm, q, ref_d2_f64, radius) -> int:
    """Found results that are not a true in-radius neighbor, on every query:
    the index names a valid target, the returned d2 is the float64 distance
    to it, that distance is inside the radius and not below the exact
    nearest."""
    def tol(x):
        return D2_RTOL * x + D2_ATOL

    f = np.flatnonzero(found)
    i = idx[f]
    ok = (i >= 0) & (i < len(t))
    ok[ok] &= tm[i[ok]]
    d2_true = np.sum((q[f].astype(np.float64)
                      - t[np.clip(i, 0, len(t) - 1)].astype(np.float64)) ** 2, axis=1)
    ok &= np.abs(d2[f].astype(np.float64) - d2_true) <= tol(d2_true)
    ok &= d2_true < radius * radius + tol(d2_true)
    ok &= d2_true >= ref_d2_f64[f] - tol(ref_d2_f64[f])
    return int(np.sum(~ok))


def capped_queries(t, tm, q, cell: float, cap: int) -> np.ndarray:
    """Queries with one of their 27 neighbor cells (edge ``cell``, the
    search radius) holding more than ``cap`` valid targets, from the
    targets on the host: there the hash grid keeps only ``cap`` candidates
    of a cell by design (ops/hashgrid.py)."""
    def key(c):
        c = c.astype(np.int64) + (1 << 20)
        return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]

    tc = np.floor(t[tm] / np.float32(cell))
    keys, counts = np.unique(key(tc), return_counts=True)
    full = keys[counts > cap]
    qc = np.floor(q / np.float32(cell))
    offs = np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                     for c in (-1, 0, 1)])
    return np.isin(key(qc[:, None, :] + offs[None]), full).any(axis=1)


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    import bench
    from direct_lidar_odometry_tpu.config import NN_BACKENDS, submap_flat_size
    from direct_lidar_odometry_tpu.ops import bruteforce, hashgrid
    from direct_lidar_odometry_tpu.registration import covariance

    cfg = bench.production_cfg()
    cap = cfg.shapes.cell_cap_1nn
    (q, qm), scan_t, sub_t = bench_clouds(cfg.shapes.n_scan, submap_flat_size(cfg))
    jq, jqm = jnp.asarray(q), jnp.asarray(qm)
    cases = [("scan", scan_t, cfg.gicp.s2s.max_correspondence_distance,
              cfg.shapes.grid_table_size),
             ("submap", sub_t, cfg.gicp.s2m.max_correspondence_distance,
              cfg.shapes.submap_table_size)]
    with jax.default_matmul_precision("highest"):
        for label, (t, tm), radius, table in cases:
            jt, jtm = jnp.asarray(t), jnp.asarray(tm)
            n_t = len(t)
            tile = min(8192, n_t)
            ref_fn = jax.jit(lambda a, b, c, d: bruteforce.query_1nn(
                a, b, c, d, radius, tile=tile))
            paths = {
                "brute": ref_fn,
                "hashgrid": jax.jit(lambda a, b, c, d: hashgrid.query_1nn(
                    hashgrid.build(a, b, radius, table), c, d, radius, cap)),
            }
            assert set(paths) >= set(NN_BACKENDS)
            r_idx, r_d2, r_found = (np.asarray(x) for x in ref_fn(jt, jtm, jq, jqm))

            # float64 host truth over the valid targets
            tv = t[tm].astype(np.float64)
            tree = cKDTree(tv)
            dd, ii = tree.query(q.astype(np.float64), k=2)
            d2_1, d2_2 = dd[:, 0] ** 2, dd[:, 1] ** 2
            gap = (d2_2 - d2_1) / np.maximum(d2_2, 1e-30)
            true_idx = np.flatnonzero(tm)[ii[:, 0]]
            d2_1 = np.where(qm, d2_1, np.inf)

            capped = qm & capped_queries(t, tm, q, radius, cap)
            in_r = d2_1 < radius * radius
            clear = np.abs(d2_1 - radius * radius) > D2_RTOL * d2_1 + D2_ATOL

            for name, fn in paths.items():
                idx, d2, found = (np.asarray(x) for x in fn(jt, jtm, jq, jqm))
                exact = qm & ~capped if name == "hashgrid" else qm
                bad_found, bad_d2, both = compare_1nn(
                    d2, found, d2_1, radius, exact)
                separated = both & (gap > TIE_RTOL)
                bad_idx_f64 = np.sum(idx[separated] != true_idx[separated])
                # against the on-card reference (same f32 arithmetic)
                agree = exact & r_found & found & (gap > TIE_RTOL)
                bad_idx_ref = np.sum(idx[agree] != r_idx[agree])
                bad_d2_ref = np.sum(
                    np.abs(d2[agree] - r_d2[agree])
                    > D2_RTOL * r_d2[agree] + D2_ATOL)
                unsound = unsound_1nn(idx, d2, found, t, tm, q, d2_1, radius)
                # off the exact set: a farther neighbor, or none, where the
                # exact nearest is inside the radius and clear of ties
                off = ~exact & qm & in_r & clear & (gap > TIE_RTOL)
                n_off = int(np.sum(off & (~found | (idx != true_idx))))
                n_capped = int(np.sum(~exact & qm))
                ms = timed(fn, jt, jtm, jq, jqm)  # hashgrid: build + query
                log(f"# 1nn {label:6s} {name:8s} Q={len(q)} T={n_t} r={radius}: "
                    f"{ms:.3f} ms/call  found {int(found.sum())}  "
                    f"exact-checked {int(exact.sum())}/{int(qm.sum())} queries  "
                    f"mismatch vs f64: found {bad_found} d2 {bad_d2} "
                    f"idx {bad_idx_f64}; vs brute: idx {bad_idx_ref} "
                    f"d2 {bad_d2_ref}; unsound {unsound}; capped-cell "
                    f"queries {n_capped}, not the exact nearest {n_off}")
                check(bad_found == bad_d2 == bad_idx_f64 == 0, "kernels",
                      f"{name} 1-NN ({label}) disagrees with the f64 reference")
                check(bad_idx_ref == bad_d2_ref == 0, "kernels",
                      f"{name} 1-NN ({label}) disagrees with brute on the card")
                check(unsound == 0, "kernels",
                      f"{name} 1-NN ({label}) returned {unsound} results that "
                      "are not in-radius neighbors at their stated distance")
                check(n_off <= CAPPED_MISS_MAX * max(n_capped, 1), "kernels",
                      f"{name} 1-NN ({label}) missed the exact nearest on "
                      f"{n_off} of {n_capped} capped-cell queries")
            hb = jax.jit(lambda a, b: hashgrid.build(a, b, radius, table))
            log(f"# hashgrid build alone {label}: {timed(hb, jt, jtm):.3f} ms/call")

        # normals over the scan queries: brute kNN and two-scale hash grid
        k = cfg.gicp.s2s.k_correspondences
        chunk = min(cfg.shapes.knn_query_chunk, len(q))
        fns = {
            "brute": jax.jit(lambda p, m: covariance.estimate_normals_brute(
                p, m, k=k, chunk=chunk)),
            "twoscale": jax.jit(lambda p, m: covariance.estimate_normals_twoscale(
                p, m, k=k, table_size=cfg.shapes.grid_table_size,
                cap=cfg.shapes.cell_cap_knn, chunk=chunk)),
        }
        nbrs = {"brute": brute_knn_sets(jq, jqm, k, chunk),
                "twoscale": twoscale_knn_sets(jq, jqm, k, cfg, chunk)}
        for name, fn in fns.items():
            nrm = fn(jq, jqm)
            n, valid = np.asarray(nrm.normals), np.asarray(nrm.valid)
            kidx, kvalid = nbrs[name]
            ref, well = plane_fit_f64(q, kidx, kvalid)
            use = valid & well
            cos = np.abs(np.sum(n[use] * ref[use], axis=1))
            ms = timed(fn, jq, jqm)
            log(f"# normals {name:8s} N={len(q)} k={k}: {ms:.3f} ms/call  "
                f"valid {int(valid.sum())}  checked {int(use.sum())}  "
                f"min |cos| {cos.min():.6f}")
            check(cos.min() >= COS_MIN, "kernels",
                  f"{name} normals disagree with the f64 plane fit")


def brute_knn_sets(p, m, k, chunk):
    from direct_lidar_odometry_tpu.ops import bruteforce

    kidx, _, kvalid = bruteforce.query_knn(p, m, p, m, k=k, chunk=chunk)
    return np.asarray(kidx), np.asarray(kvalid)


def twoscale_knn_sets(p, m, k, cfg, chunk):
    """The neighbor sets estimate_normals_twoscale fits (fine window, or
    the far window where the fine one holds fewer than k)."""
    from direct_lidar_odometry_tpu.ops import hashgrid

    fine = hashgrid.build(p, m, 1.0, cfg.shapes.grid_table_size)
    far = hashgrid.build(p, m, 3.0, cfg.shapes.grid_table_size)
    i1, _, v1 = hashgrid.query_knn(fine, p, m, k=k, cap=cfg.shapes.cell_cap_knn,
                                   chunk=chunk)
    i2, _, v2 = hashgrid.query_knn(far, p, m, k=k, cap=32, chunk=chunk)
    i1, v1, i2, v2 = (np.asarray(x) for x in (i1, v1, i2, v2))
    use_far = (v1.sum(axis=1) < k)[:, None]
    return np.where(use_far, i2, i1), np.where(use_far, v2, v1)


def plane_fit_f64(pts, kidx, kvalid):
    """float64 smallest-eigenvector normals over the given neighbor sets;
    ``well``: the smallest eigenvalue is separated from the middle one by
    more than 1% of the largest (elsewhere the normal is ill-defined)."""
    nb = pts.astype(np.float64)[np.clip(kidx, 0, None)]
    w = kvalid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(axis=1), 1.0)
    mean = (nb * w).sum(axis=1) / cnt
    c = (nb - mean[:, None]) * w
    cov = np.einsum("nki,nkj->nij", c, c) / cnt[..., None]
    lam, vec = np.linalg.eigh(cov)
    well = (lam[:, 1] - lam[:, 0]) > 1e-2 * np.maximum(lam[:, 2], 1e-30)
    return vec[:, :, 0], well & (kvalid.sum(axis=1) >= 3)


# ------------------------------------------------------------------- pipeline
def phase_pipeline(card: str) -> None:
    import jax

    import bench
    from direct_lidar_odometry_tpu.io import evaluation, synthetic
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner

    cfg = bench.production_cfg()
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = bench.make_bench_world(FRAMES, rng, False)
    scans = [synthetic.render_scan(world, t, rng, max_range=max_range,
                                   max_points=max_pts, beams=beams)
             for t in range(FRAMES)]
    stamps = [float(s) for s in world.stamps[:FRAMES]]
    log(f"# pipeline: {FRAMES} frames, mean {np.mean([len(s) for s in scans]):.0f} "
        f"raw pts, backend {cfg.nn_backend}")

    runner = OdometryRunner(cfg)
    t0 = time.perf_counter()
    for th in runner.precompile_async(chunk=CHUNK):
        th.join()
    check(not runner._precompile_errors, "pipeline",
          f"precompile failed: {runner._precompile_errors!r}")
    cold_s = time.perf_counter() - t0
    for t in range(WARMUP):
        runner.process_scan(scans[t], stamps[t], sync=True)
    t = WARMUP
    chunk_ms = []
    while t + CHUNK <= FRAMES:
        tc = time.perf_counter()
        r = runner.process_chunk(scans[t:t + CHUNK], stamps[t:t + CHUNK])
        np.asarray(r.position)
        chunk_ms.append((time.perf_counter() - tc) * 1e3 / CHUNK)
        t += CHUNK
    n_done = t
    est = runner.trajectory()
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[:n_done]
    ate = evaluation.ate(est, gt, align=False).rmse
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    gate = max(0.10, 0.001 * path)
    log(f"# ATE {ate:.4f} m over {path:.1f} m (gate {gate:.3f} m), "
        f"{runner.num_keyframes()} keyframes")
    check(np.isfinite(ate) and ate <= gate, "pipeline",
          f"ATE {ate:.4f} m above the gate {gate:.3f} m")

    # per-frame stepping of the same frames must give the same poses
    single = OdometryRunner(cfg)
    for i in range(n_done):
        single.process_scan(scans[i], stamps[i])
    dpos = np.abs(single.trajectory()[:, :3, 3] - est[:, :3, 3]).max()
    log(f"# chunked vs per-frame: max |d position| {dpos * 1e3:.4f} mm")
    check(dpos <= POSE_ATOL_M, "pipeline",
          f"chunked and per-frame poses differ by {dpos * 1e3:.3f} mm")

    # warm compile: a fresh runner re-traces and hits the persistent cache
    fresh = OdometryRunner(cfg)
    t0 = time.perf_counter()
    for th in fresh.precompile_async(chunk=CHUNK):
        th.join()
    warm_s = time.perf_counter() - t0

    for name, fn, args in compiled_programs(runner):
        ma = fn.lower(*args).compile().memory_analysis()
        log(f"# memory_analysis {name} [{card}]: args "
            f"{ma.argument_size_in_bytes} out {ma.output_size_in_bytes} "
            f"temp {ma.temp_size_in_bytes} code {ma.generated_code_size_in_bytes} "
            f"alias {ma.alias_size_in_bytes} bytes")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"# peak_bytes_in_use [{card}]: {stats.get('peak_bytes_in_use')}")
    log(f"# compile [{card}]: cold {cold_s:.1f} s, warm {warm_s:.1f} s "
        f"(step + chunked step, in parallel threads)")
    log(f"# warm wall [{card}]: chunk ms/frame "
        + " ".join(f"{c:.2f}" for c in chunk_ms)
        + f"; median of chunks 2.. {np.median(chunk_ms[1:]):.2f} ms/frame")


def compiled_programs(runner):
    """(name, jitted fn, abstract args) of the step and the chunked step."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from direct_lidar_odometry_tpu.odometry import pipeline

    cfg = runner.cfg
    sds = jax.ShapeDtypeStruct
    state = jax.eval_shape(partial(pipeline.fresh_state, cfg))
    cap = runner._wire_capacity()
    wire = (sds((cap, 3), jnp.uint16), sds((3,), jnp.float32),
            sds((3,), jnp.float32), sds((), jnp.int32))
    prior = sds((4, 4), jnp.float32)
    k = cfg.shapes.max_keyframes
    hull = (sds((k,), jnp.bool_), sds((k,), jnp.bool_), sds((), jnp.bool_))
    stacked = tuple(sds((CHUNK,) + a.shape, a.dtype) for a in (*wire, prior))
    return [("step", runner.step_fn, (state, *wire, prior, *hull)),
            ("chunked_step", runner._chunk_fn, (state, *stacked, *hull))]


# ---------------------------------------------------------------- loopclosure
def phase_loopclosure(card: str) -> None:
    import bench

    res = bench._loop_closure_check(bench.production_cfg())
    log(f"# loopclosure [{card}]: {json.dumps(res)}")
    check(res["loop_edges"] > 0, "loopclosure", "no loop edge accepted")
    check(res["kf_map_err_after_m"] < res["kf_map_err_before_m"], "loopclosure",
          "keyframe-map error did not fall after the refine")


# ------------------------------------------------------------------ 4 devices
def phase_sharded(n_dev: int, card: str) -> None:
    import jax
    import jax.numpy as jnp

    import bench
    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.parallel import batched, posegraph, sharded

    check(len(jax.devices()) >= n_dev, "sharded",
          f"{n_dev} devices asked, {len(jax.devices())} present")
    cfg = bench.production_cfg()
    n_raw = cfg.shapes.n_raw
    frames = 6
    lanes = []
    for seed in range(n_dev):
        rng = np.random.default_rng(100 + seed)
        world, max_range, max_pts, beams = bench.make_bench_world(frames, rng, False)
        lanes.append([synthetic.render_scan(world, t, rng, max_range=max_range,
                                            max_points=max_pts, beams=beams)
                      for t in range(frames)])

    def stacked(t):
        pts = np.full((n_dev, n_raw, 3), 1e6, np.float32)
        mask = np.zeros((n_dev, n_raw), bool)
        for b in range(n_dev):
            s = lanes[b][t][:n_raw]
            pts[b, :len(s)], mask[b, :len(s)] = s, True
        return pts, mask

    eye = np.tile(np.eye(4, dtype=np.float32), (n_dev, 1, 1))
    mesh = sharded.make_mesh(n_dev)
    step = sharded.make_sharded_step(cfg, mesh)
    init_fn, one_step = batched.make_batched_fns(cfg)
    st_sh = sharded.shard_states(batched.batched_state(cfg, n_dev), mesh)
    st_sh = init_fn(st_sh, *(jnp.asarray(a) for a in stacked(0)))
    dev0 = jax.devices()[0]
    st_one = jax.device_put(batched.batched_state(cfg, n_dev), dev0)
    st_one = init_fn(st_one, *(jax.device_put(a, dev0) for a in stacked(0)))
    worst = 0.0
    sh_ms = []
    for t in range(1, frames):
        pts, mask = stacked(t)
        t0 = time.perf_counter()
        st_sh, res_sh, mean_corr, max_err = step(
            st_sh, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(eye))
        pos_sh = np.asarray(res_sh.position)
        sh_ms.append((time.perf_counter() - t0) * 1e3)
        st_one, res_one = one_step(st_one, jax.device_put(pts, dev0),
                                   jax.device_put(mask, dev0),
                                   jax.device_put(eye, dev0))
        worst = max(worst, float(np.abs(pos_sh - np.asarray(res_one.position)).max()))
        check(np.isfinite(float(max_err)) and float(mean_corr) > 0, "sharded",
              "fleet health reduction is not finite")
    log(f"# sharded step [{card}]: {n_dev} lanes over {n_dev} cards, "
        f"{frames - 1} steps, ms/step " + " ".join(f"{m:.1f}" for m in sh_ms))
    log(f"# sharded vs batched on one card: max |d position| {worst * 1e3:.4f} mm")
    check(worst <= POSE_ATOL_M, "sharded",
          f"sharded and one-card batched lanes differ by {worst * 1e3:.3f} mm")

    graph = noisy_chain_graph(np.random.default_rng(3), k=128, m=256)
    single, err_s = posegraph.refine(graph, iterations=5)
    emesh = sharded.make_mesh(n_dev, axis="edge")
    dist, err_d = sharded.make_distributed_refine(emesh, iterations=5)(graph)
    dp = float(np.abs(np.asarray(single) - np.asarray(dist)).max())
    log(f"# distributed refine over {n_dev} cards vs posegraph.refine: "
        f"max |d pose| {dp:.2e}, error {float(err_s):.3e} vs {float(err_d):.3e}")
    check(dp <= 1e-3, "sharded", "distributed refine differs from refine")


def noisy_chain_graph(rng, k: int, m: int):
    """A K-pose chain with skip edges (exact relative measurements) and
    noisy pose estimates, padded to M edges."""
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.core import se3
    from direct_lidar_odometry_tpu.parallel import posegraph

    def exp(d):
        return np.asarray(se3.se3_exp(jnp.asarray(d, jnp.float32)), np.float64)

    gt = [np.eye(4)]
    for _ in range(1, k):
        d = np.concatenate([rng.normal(scale=0.05, size=3),
                            [1.0, rng.normal(scale=0.2), 0.0]])
        gt.append(gt[-1] @ exp(d))
    noisy = [gt[0]] + [g @ exp(rng.normal(scale=0.05, size=6)) for g in gt[1:]]
    edges = [(i, i + 1) for i in range(k - 1)] + [(i, i + 2) for i in range(0, k - 2, 3)]
    edges = edges[:m]
    rels = [np.linalg.inv(gt[i]) @ gt[j] for i, j in edges]
    n_pad = m - len(edges)
    emask = np.array([True] * len(edges) + [False] * n_pad)
    edges += [(0, 0)] * n_pad
    rels += [np.eye(4)] * n_pad
    return posegraph.PoseGraph(
        poses=jnp.asarray(np.asarray(noisy), jnp.float32),
        pose_mask=jnp.ones((k,), bool),
        edges=jnp.asarray(np.asarray(edges, np.int32)),
        rel=jnp.asarray(np.asarray(rels), jnp.float32),
        edge_mask=jnp.asarray(emask),
        weights=jnp.ones((m,), jnp.float32),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path across four cards")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"FAIL [device] needs a GPU; JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = gpu_name_and_power()
    info = phase_device(card)
    t_start = time.perf_counter()
    if args.devices == 4:
        phase_sharded(4, card)
        info["count"] = len(jax.devices())
    else:
        for name, phase in (("kernels", phase_kernels),
                            ("pipeline", lambda: phase_pipeline(card)),
                            ("loopclosure", lambda: phase_loopclosure(card))):
            t0 = time.perf_counter()
            phase()
            log(f"# phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    log(f"# all phases ok in {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
