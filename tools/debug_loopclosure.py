"""Dissect an end-to-end loop-closure round: measurement vs solver.

Reproduces the long_validation noise-burst sequence, then inspects every
stage of the final refinement: which candidate pairs fire, how far each
GICP loop measurement Z is from the GROUND-TRUTH relative pose (exact
association via KeyframeStore.seq = spawn frame), and what the GN
refinement does to per-keyframe error. Run:

    SMALL=1 LV_FRAMES=300 LV_NOISE_BURST=100:140:0.15 LV_MAX_KF=128 \
        JAX_PLATFORMS=cpu python tools/debug_loopclosure.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig, resolve_backend
    from direct_lidar_odometry_tpu.core import se3
    from direct_lidar_odometry_tpu.io import synthetic
    from direct_lidar_odometry_tpu.odometry import loopclosure
    from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner
    from direct_lidar_odometry_tpu.parallel import posegraph

    n_frames = int(os.environ.get("LV_FRAMES", "300"))
    burst = os.environ.get("LV_NOISE_BURST", "100:140:0.15")
    b_start, b_end, b_sigma = burst.split(":")
    burst = (int(b_start), int(b_end), float(b_sigma))
    max_kf = int(os.environ.get("LV_MAX_KF", "128"))

    base = DloConfig().replace(
        s2s_prior="constant_velocity",
        shapes=ShapeConfig(
            n_raw=8192, n_scan=8192, n_keyframe=8192, max_keyframes=max_kf,
            max_submap_kf=8, imu_window=64, grid_table_size=2 ** 14,
            submap_table_size=2 ** 15, cell_cap_1nn=16, cell_cap_knn=48,
            knn_query_chunk=2048, hull_directions=32,
        ),
    )
    cfg = dataclasses.replace(
        base,
        posegraph=dataclasses.replace(
            base.posegraph, use=False, min_index_gap=20,
            loop_radius=6.0, check_every=64,
        ),
    )
    rng = np.random.default_rng(11)
    world = synthetic.make_loop_world(
        rng, n_frames=n_frames, speed=0.4, z_amplitude=1.5,
        density=6.0, ground_density=9.0,
    )
    from direct_lidar_odometry_tpu.utils import checkpoint as ckpt

    cache = os.environ.get("DLC_CACHE", "/tmp/debug_lc_state.npz")
    if cache and os.path.exists(cache):
        state, _ = ckpt.load_state(cache, cfg)
        runner = OdometryRunner(cfg)
        runner.state = state
        print(f"# loaded cached end state from {cache}")
    else:
        runner = OdometryRunner(cfg)
        srng = np.random.default_rng(3)
        for t in range(n_frames):
            nz = burst[2] if burst[0] <= t < burst[1] else 0.01
            scan = synthetic.render_scan(world, t, srng, max_range=13.0,
                                         max_points=8192, noise=nz)
            runner.process_scan(scan, float(world.stamps[t]))
        if cache:
            ckpt.save_state(cache, runner.state)

    gt_all = np.linalg.inv(world.poses[0])[None] @ world.poses
    store = runner.state.keyframes
    kfc = int(store.count)
    seq = np.asarray(store.seq[:kfc])
    pos = np.asarray(store.positions[:kfc])
    kf_err = np.linalg.norm(pos - gt_all[seq, :3, 3], axis=-1)
    print(f"# {kfc} keyframes; per-kf err mean {kf_err.mean():.4f} "
          f"max {kf_err.max():.4f}")
    # rotational drift per keyframe vs GT
    from direct_lidar_odometry_tpu.core import se3 as _se3
    import jax.numpy as _jnp
    quats_all = np.asarray(store.quats[:kfc])
    rot_err = []
    for kk in range(kfc):
        r_est = np.asarray(_se3.quat_to_rotmat(_jnp.asarray(quats_all[kk])))
        r_gt = gt_all[seq[kk], :3, :3]
        c = np.clip((np.trace(r_est @ r_gt.T) - 1) / 2, -1, 1)
        rot_err.append(np.degrees(np.arccos(c)))
    rot_err = np.asarray(rot_err)
    print(f"# rot drift deg: mean {rot_err.mean():.3f} max {rot_err.max():.3f} "
          f"last5 {np.round(rot_err[-5:], 3).tolist()}")

    pg = cfg.posegraph
    backend = resolve_backend(cfg)
    # f32 matmuls: reduced-precision products corrupt pose composition at
    # map scale (the bug this tool found); match the runner's guarded path
    _f32 = jax.default_matmul_precision("float32")
    _f32.__enter__()
    edges, cand_mask = loopclosure.loop_candidates(
        store, pg.loop_radius, pg.min_index_gap, pg.max_loops)
    loops = loopclosure.register_loop_edges(store, edges, cand_mask, cfg, backend)
    e = np.asarray(edges)
    w = np.asarray(loops.weight)
    rel = np.asarray(loops.rel)
    for l in range(len(e)):
        if not bool(np.asarray(cand_mask)[l]):
            continue
        i, j = int(e[l, 0]), int(e[l, 1])
        z_true = np.linalg.inv(gt_all[seq[i]]) @ gt_all[seq[j]]
        dt = np.linalg.norm(rel[l][:3, 3] - z_true[:3, 3])

        def _ang(r):
            return float(np.degrees(np.arccos(
                np.clip((np.trace(r[:3, :3]) - 1) / 2, -1, 1))))

        # rotation error of the measurement, and the residual at current
        # estimates (what the graph will try to remove)
        quats = np.asarray(store.quats[:kfc])
        def _pose(idx):
            from direct_lidar_odometry_tpu.core import se3 as _se3
            import jax.numpy as _jnp
            r = np.asarray(_se3.quat_to_rotmat(_jnp.asarray(quats[idx])))
            x = np.eye(4); x[:3, :3] = r; x[:3, 3] = pos[idx]
            return x
        cur_rel = np.linalg.inv(_pose(i)) @ _pose(j)
        resid = np.linalg.inv(rel[l]) @ cur_rel
        print(json.dumps({
            "edge": [i, j], "seq": [int(seq[i]), int(seq[j])],
            "weight": float(w[l]),
            "num_corr": int(np.asarray(loops.num_corr)[l]),
            "z_err_m": round(float(dt), 4),
            "z_rot_err_deg": round(_ang(rel[l] @ np.linalg.inv(z_true)), 4),
            "resid_t_m": round(float(np.linalg.norm(resid[:3, 3])), 4),
            "resid_rot_deg": round(_ang(resid), 4),
        }))

    graph = loopclosure.build_refinement_graph(store, loops, pg.chain_weight)
    for iters in (2, 8, 24):
        new_poses, err = posegraph.refine(graph, iterations=iters)
        np_pos = np.asarray(new_poses)[:kfc, :3, 3]
        kf_err2 = np.linalg.norm(np_pos - gt_all[seq, :3, 3], axis=-1)
        print(json.dumps({
            "iters": iters, "graph_error": round(float(err), 5),
            "kf_err_after_mean": round(float(kf_err2.mean()), 4),
            "kf_err_after_max": round(float(kf_err2.max()), 4),
            "max_move": round(float(np.linalg.norm(
                np_pos - pos, axis=-1).max()), 4),
        }))

    # ---- f64 oracle GN on the SAME graph: exact numeric Jacobians ----
    # splits "objective is wrong" from "our GN/Jacobians are wrong"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from tests.test_loopclosure import _residual_np, _retract

    k = int(graph.poses.shape[0])
    E = np.asarray(graph.edges)
    REL = np.asarray(graph.rel, np.float64)
    EM = np.asarray(graph.edge_mask)
    W = np.asarray(graph.weights, np.float64)
    X = np.asarray(graph.poses, np.float64).copy()
    PM = np.asarray(graph.pose_mask)

    def solve_numpy(X, iters=20, pin_w=1e6, damp=1e-4):
        X = X.copy()
        for _ in range(iters):
            H = np.zeros((k * 6, k * 6))
            g = np.zeros(k * 6)
            for l in range(len(E)):
                if not EM[l]:
                    continue
                i, j = int(E[l, 0]), int(E[l, 1])
                r = _residual_np(X[i], X[j], REL[l])
                Ji = np.zeros((6, 6)); Jj = np.zeros((6, 6))
                eps = 1e-6
                for a in range(6):
                    d = np.zeros(6); d[a] = eps
                    Ji[:, a] = (_residual_np(_retract(X[i], d), X[j], REL[l])
                                - _residual_np(_retract(X[i], -d), X[j], REL[l])) / (2 * eps)
                    Jj[:, a] = (_residual_np(X[i], _retract(X[j], d), REL[l])
                                - _residual_np(X[i], _retract(X[j], -d), REL[l])) / (2 * eps)
                w = W[l]
                si, sj = slice(i * 6, i * 6 + 6), slice(j * 6, j * 6 + 6)
                H[si, si] += w * Ji.T @ Ji
                H[sj, sj] += w * Jj.T @ Jj
                H[si, sj] += w * Ji.T @ Jj
                H[sj, si] += w * Jj.T @ Ji
                g[si] += w * Ji.T @ r
                g[sj] += w * Jj.T @ r
            diag = np.full(k * 6, damp)
            diag[:6] += pin_w
            for p in range(k):
                if not PM[p]:
                    diag[p * 6 : p * 6 + 6] += 1e9
            H[np.diag_indices_from(H)] += diag
            delta = np.linalg.solve(H, -g)
            for p in range(k):
                if PM[p]:
                    X[p] = _retract(X[p], delta[p * 6 : p * 6 + 6])
        return X

    Xr = solve_numpy(X)
    np_pos = Xr[:kfc, :3, 3]
    kf_err3 = np.linalg.norm(np_pos - gt_all[seq, :3, 3], axis=-1)
    print(json.dumps({
        "solver": "numpy_f64_numeric_jacobians", "iters": 20,
        "kf_err_after_mean": round(float(kf_err3.mean()), 4),
        "kf_err_after_max": round(float(kf_err3.max()), 4),
        "max_move": round(float(np.linalg.norm(
            np_pos - pos, axis=-1).max()), 4),
    }))


if __name__ == "__main__":
    main()
