"""Host-side sequence driver.

The functional analog of the reference's process shell: ROS callbacks,
spinners, and lifecycle (``odom_node.cc``, ``odom.cc:586-697``) become a
plain Python loop that feeds device arrays to the jitted init/step
functions, maintains the IMU buffer, and collects the trajectory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from direct_lidar_odometry_tpu.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu.core import cloud as cl, se3
from direct_lidar_odometry_tpu.odometry import (
    hosthull, imu as imu_mod, loopclosure, mapper, pipeline,
)
from direct_lidar_odometry_tpu.odometry.state import FrameResult, OdomState


@dataclass
class FrameStats:
    stamp: float
    wall_ms: float
    result: FrameResult | None


class OdometryRunner:
    """Drive one LiDAR (+IMU) sequence through the jitted pipeline."""

    def __init__(self, cfg: DloConfig):
        if cfg.host_preprocess and not cfg.preprocessing.voxel_scan.use:
            # host preprocessing exists to move the voxel+Morton sort off
            # the device; without voxelization there is nothing to move
            cfg = cfg.replace(host_preprocess=False)
        self.cfg = cfg
        if cfg.quantize_transfer:
            self.init_fn, self.step_fn = pipeline.make_quantized_step_fns(cfg)
        else:
            self.init_fn, self.step_fn = pipeline.make_step_fns(cfg)
        self.imu = (
            imu_mod.ImuBuffer(cfg.imu.calib_time, cfg.imu.buffer_size)
            if cfg.imu.use
            else None
        )
        self._chunk_fn = None
        self._refine_fn = None
        self._precompile_errors: list = []
        self._kf_at_refine = 0
        self._frames_since_refine_check = 0
        self.refine_log: list[dict] = []
        # exact host hull masks (hosthull.py), refreshed one frame behind
        k = cfg.shapes.max_keyframes
        self._hull_cvx = np.zeros((k,), bool)
        self._hull_ccv = np.zeros((k,), bool)
        self._hull_fresh = False
        self._hull_pending = None   # (positions, count, thresh) device refs
        self._hull_sig = None       # bytes of last positions hulled
        self._hull_dev = None       # cached device-side mask args
        # intensity sidecar (cfg.map.carry_intensity): host mirror of the
        # keyframe ring as sensor-frame xyzi reduced scans. Slots are kept
        # in sync with device eviction via FrameResult.kf_slot; resolution
        # of "did frame t spawn a keyframe" is deferred so the async
        # dispatch pipeline is never forced to sync (pending scans are
        # bounded; old results are long since computed when force-read).
        self._ikf: dict[int, np.ndarray] = {}
        self._ipending: list[tuple] = []  # (result, idx_in_chunk|None, scan4)
        self._ipending_max = 32
        self.state: OdomState | None = None
        self.prev_stamp: float | None = None
        self.poses: list[np.ndarray] = []
        self.stamps: list[float] = []
        self.stats: list[FrameStats] = []
        self._identity = jnp.eye(4, dtype=jnp.float32)

    # -- compile overlap ---------------------------------------------------
    def precompile_async(self, chunk: int | None = None) -> list:
        """Start compiling the per-frame step (and, when ``chunk`` is
        given, the K-frame chunked step) in background daemon threads, on
        abstract ShapeDtypeStructs — no real data, no device buffers.

        Rationale: the three jit programs (init, step, chunked step)
        otherwise compile serially on first use, and at production shapes
        each costs tens of seconds to minutes. XLA compilation happens in
        C++ with the GIL released, so backgrounding it overlaps the
        step/chunk compiles with the foreground init compile and the first
        frames. The foreground jit call re-traces but then hits the
        persistent compilation cache (enabled package-wide,
        utils/cachedir.py) instead of recompiling.

        Returns the threads (daemonized; join only for testing).
        """
        import threading

        import jax

        from functools import partial as _partial

        cfg = self.cfg
        sds = jax.ShapeDtypeStruct
        state_abs = jax.eval_shape(_partial(pipeline.fresh_state, cfg))
        cap = self._wire_capacity()
        if cfg.quantize_transfer:
            wire = (
                sds((cap, 3), jnp.uint16), sds((3,), jnp.float32),
                sds((3,), jnp.float32), sds((), jnp.int32),
            )
        else:
            wire = (sds((cap, 3), jnp.float32), sds((cap,), jnp.bool_))
        prior = sds((4, 4), jnp.float32)
        k = cfg.shapes.max_keyframes
        hull = (sds((k,), jnp.bool_), sds((k,), jnp.bool_), sds((), jnp.bool_))

        def bg(fn, args):
            try:
                fn.lower(*args).compile()
            except Exception as e:  # best-effort: foreground compiles anyway
                # surface drift between the abstract argument specs and the
                # real step signature — a silent mismatch would disable the
                # compile-overlap optimization with no signal
                import sys as _sys

                print(f"# precompile_async failed: {e!r}", file=_sys.stderr)
                self._precompile_errors.append(e)

        jobs = [(self.step_fn, (state_abs, *wire, prior, *hull))]
        if chunk is not None and chunk > 1:
            if self._chunk_fn is None:
                self._chunk_fn = pipeline.make_chunked_step_fn(cfg)
            stacked = tuple(
                sds((chunk,) + a.shape, a.dtype) for a in (*wire, prior)
            )
            jobs.append((self._chunk_fn, (state_abs, *stacked, *hull)))
        threads = []
        for fn, args in jobs:
            t = threading.Thread(target=bg, args=(fn, args), daemon=True)
            t.start()
            threads.append(t)
        return threads

    # -- sensor inputs ----------------------------------------------------
    def push_imu(self, stamp: float, gyro, accel) -> None:
        if self.imu is not None:
            self.imu.push(stamp, gyro, accel)

    def _initial_pose(self) -> jnp.ndarray:
        """Known initial pose and/or gravity alignment (odom.cc:586-622)."""
        cfg = self.cfg
        rot = jnp.eye(3, dtype=jnp.float32)
        pos = jnp.zeros(3, jnp.float32)
        if cfg.gravity_align and self.imu is not None and self.imu.calibrated:
            q = imu_mod.gravity_align_quat(jnp.asarray(self.imu.accel_mean))
            rot = se3.quat_to_rotmat(q)
        if cfg.initial_pose.use:
            pos = jnp.asarray(cfg.initial_pose.position, jnp.float32)
            q = jnp.asarray(cfg.initial_pose.orientation_wxyz, jnp.float32)
            rot = se3.quat_to_rotmat(q)
        return se3.make_se3(rot, pos)

    def process_scan(
        self, points: np.ndarray, stamp: float, sync: bool = False
    ) -> FrameResult | None:
        """One LiDAR frame. Returns None for rejected/initialization frames.

        By default this only *dispatches* the frame: the returned
        FrameResult holds device arrays and the call returns as soon as the
        step is enqueued, so host prep of frame t+1 overlaps device compute
        of frame t (the reference gets the same overlap from its detached
        publish threads, ``odom.cc:690-695``). Pass ``sync=True`` (or touch
        any result field) to block until the frame is done — then
        ``FrameStats.wall_ms`` is true per-frame latency rather than
        dispatch time.
        """
        cfg = self.cfg
        t0 = time.perf_counter()
        if points.shape[0] < cfg.gicp.min_num_points:  # odom.cc:638-641
            return None
        if cfg.imu.use and self.imu is not None and not self.imu.calibrated:
            # reference waits for IMU calibration before initializing
            # (odom.cc:589-591)
            return None

        scan_args = self._encode_scan(points)

        if self.state is None:
            state = pipeline.fresh_state(cfg, self._initial_pose())
            self.state = self.init_fn(state, *scan_args)
            if self._carry_intensity(points):
                # init frame always writes keyframe slot 0 (odom.cc:483-505)
                self._ikf[0] = self._reduce_xyzi(points)
            self._enqueue_hull_fetch(jnp.float32(cfg.keyframe.thresh_dist))
            self.prev_stamp = stamp
            # copy, not the state leaf: the next step donates the state and
            # would invalidate a stored leaf reference
            self.poses.append(jnp.copy(self.state.pose))
            self.stamps.append(stamp)
            self.stats.append(
                FrameStats(stamp, (time.perf_counter() - t0) * 1e3, None)
            )
            return None

        imu_prior = self._identity
        if cfg.imu.use and self.imu is not None:
            window, _count = self.imu.window(
                self.prev_stamp, stamp, cfg.shapes.imu_window
            )
            # host integration: a per-frame device program for ~10
            # quaternion products costs a dispatch and a sync per frame
            imu_prior = jnp.asarray(
                imu_mod.integrate_window_host(window, _count)
            )

        self._refresh_hull_masks()
        self.state, result = self.step_fn(
            self.state, *scan_args, imu_prior, *self._hull_args()
        )
        self._enqueue_hull_fetch(result.keyframe_thresh_dist)
        if self._carry_intensity(points):
            self._ipending.append((result, None, points))
            self._resolve_intensity()
        self.prev_stamp = stamp
        self.poses.append(result.pose)
        self.stamps.append(stamp)
        if sync:
            # materializing a tiny output waits for the whole step
            np.asarray(result.position)
        self.stats.append(FrameStats(stamp, (time.perf_counter() - t0) * 1e3, result))
        if cfg.posegraph.use:
            # trigger check is host-synced (reads keyframe count), so it is
            # rate-limited to every check_every frames to keep the async
            # dispatch pipeline intact between checks
            self._frames_since_refine_check += 1
            if self._frames_since_refine_check >= cfg.posegraph.check_every:
                self._frames_since_refine_check = 0
                self.maybe_refine()
        return result

    def _wire_capacity(self) -> int:
        """Points per scan on the wire: host preprocessing shrinks the
        transfer from the raw capacity to the voxel capacity (~4x)."""
        cfg = self.cfg
        return cfg.shapes.n_scan if cfg.host_preprocess else cfg.shapes.n_raw

    def _prep_points(self, points: np.ndarray) -> np.ndarray:
        """Host-side preprocessing when enabled (io/hostprep.py): the
        device step then skips NaN/crop/voxel/Morton entirely."""
        cfg = self.cfg
        if not cfg.host_preprocess:
            return points
        from direct_lidar_odometry_tpu.io import hostprep

        crop = cfg.preprocessing.crop.size if cfg.preprocessing.crop.use else None
        return hostprep.preprocess_morton(
            points, crop, cfg.preprocessing.voxel_scan.res, cfg.shapes.n_scan
        )

    def _encode_scan(self, points: np.ndarray) -> tuple:
        cfg = self.cfg
        pts = self._prep_points(points)
        cap = self._wire_capacity()
        if cfg.quantize_transfer:
            qs = cl.quantize_for_transfer(pts[:, :3], cap)
            return (qs.q, qs.lo, qs.scale, qs.count)
        raw = cl.from_numpy(pts[:, :3], cap)
        return (raw.points, raw.mask)

    def prepare_chunk(self, scans, to_device: bool = True) -> tuple:
        """Host-side wire-format encode of a chunk of scans (stacked).

        Separated from :meth:`process_chunk` so callers can run it in a
        background thread for the NEXT chunk while the device computes the
        current one — the encode is numpy / GIL-releasing C++
        (native.quantize), so it genuinely overlaps. At 131k-point scans
        the encode costs milliseconds per scan on the host, which otherwise
        serializes with dispatch and caps throughput.

        ``to_device``: also start the host->device transfer here (in the
        worker thread), so the ~1.6 MB chunk upload overlaps the previous
        chunk's compute instead of serializing with dispatch.
        """
        cfg = self.cfg
        cap = self._wire_capacity()
        if cfg.quantize_transfer:
            qs = [
                cl.quantize_for_transfer(self._prep_points(s)[:, :3], cap)
                for s in scans
            ]
            out = (
                np.stack([x.q for x in qs]),
                np.stack([x.lo for x in qs]),
                np.stack([x.scale for x in qs]),
                np.stack([x.count for x in qs]),
            )
        else:
            k = len(scans)
            pts = np.full((k, cap, 3), cl.PAD_VALUE, np.float32)
            mask = np.zeros((k, cap), bool)
            for i, s in enumerate(scans):
                p = self._prep_points(s)
                m = min(len(p), cap)
                pts[i, :m] = p[:m, :3]
                mask[i, :m] = True
            out = (pts, mask)
        if to_device:
            out = tuple(jnp.asarray(a) for a in out)
        return out

    def process_chunk(self, scans, stamps, prepared: tuple | None = None) -> FrameResult:
        """K frames in ONE device dispatch (offline/throughput path).

        Requires an initialized state (feed the first frames through
        :meth:`process_scan`). Scans whose point count is below
        ``min_num_points`` must be filtered by the caller. Returns the
        stacked FrameResult; poses/stamps bookkeeping matches per-frame
        stepping. The dispatch is async like ``process_scan`` — touch any
        result field to synchronize. ``prepared``: pre-encoded host arrays
        from :meth:`prepare_chunk` (same scans), typically produced in a
        background thread.
        """
        assert self.state is not None, "initialize with process_scan first"
        cfg = self.cfg
        k = len(scans)
        assert k == len(stamps) and k > 0
        t0 = time.perf_counter()

        priors = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
        if cfg.imu.use and self.imu is not None:
            prev = self.prev_stamp
            for i, stamp in enumerate(stamps):
                window, count = self.imu.window(prev, stamp, cfg.shapes.imu_window)
                # host integration: a device version would add one
                # dispatch and sync per frame
                priors[i] = imu_mod.integrate_window_host(window, count)
                prev = stamp

        stacked = prepared if prepared is not None else self.prepare_chunk(scans)

        if self._chunk_fn is None:
            self._chunk_fn = pipeline.make_chunked_step_fn(cfg)
        self._refresh_hull_masks()
        self.state, res = self._chunk_fn(
            self.state, *stacked, jnp.asarray(priors), *self._hull_args()
        )
        self._enqueue_hull_fetch(res.keyframe_thresh_dist[-1])
        if self.cfg.map.carry_intensity:
            for i, s in enumerate(scans):
                if self._carry_intensity(s):
                    self._ipending.append((res, i, s))
            self._resolve_intensity()
        self.prev_stamp = stamps[-1]
        wall = (time.perf_counter() - t0) * 1e3 / k
        for i in range(k):
            self.poses.append(res.pose[i])
            self.stamps.append(stamps[i])
            self.stats.append(FrameStats(stamps[i], wall, None))
        return res

    # -- exact host hulls (one frame behind) --------------------------------
    def _refresh_hull_masks(self) -> None:
        """Materialize the async positions fetch enqueued last frame and
        recompute exact QHull membership masks if the keyframe set (or the
        adaptive alpha) changed. The fetch was issued right after the
        previous dispatch, so by now it is normally complete — this stays
        one frame behind without stalling the pipeline (hosthull.py)."""
        if self._hull_pending is None:
            return
        pos_ref, cnt_ref, thresh_ref = self._hull_pending
        # never block the dispatch pipeline: if the producing step has not
        # finished yet, keep the fetch pending and try again next frame
        # (mask staleness grows by a frame; the reference tolerates stale
        # submaps the same way, odom.cc:1309)
        for r in (pos_ref, cnt_ref, thresh_ref):
            if hasattr(r, "is_ready") and not r.is_ready():
                return
        self._hull_pending = None
        pos = np.asarray(pos_ref)
        cnt = int(cnt_ref)
        thresh = float(thresh_ref)
        sig = pos[:cnt].tobytes() + np.float32(thresh).tobytes()
        if sig == self._hull_sig:
            return
        self._hull_sig = sig
        self._hull_cvx, self._hull_ccv = hosthull.host_hull_masks(
            pos, cnt, thresh, len(self._hull_cvx)
        )
        self._hull_fresh = True
        self._hull_dev = None  # invalidate cached device-side masks

    def _enqueue_hull_fetch(self, thresh_ref) -> None:
        if self.state is None:
            return
        if self._hull_pending is not None:
            # an unconsumed fetch is still in flight; keep it — replacing
            # it every frame would chase the queue tail and never be ready
            # under pipelined dispatch
            return
        # device-side copies, NOT the state leaves themselves: the step fns
        # donate the state, so by the time a slow async fetch resolves the
        # original positions/count buffers may have been invalidated by the
        # next dispatch. The copy is ~6 KB of device work enqueued after
        # the producing step; its buffers are never donated.
        refs = (jnp.copy(self.state.keyframes.positions),
                jnp.copy(self.state.keyframes.count),
                thresh_ref)
        for r in refs:
            try:
                r.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass
        self._hull_pending = refs

    def _hull_args(self):
        if self._hull_dev is None:
            self._hull_dev = (
                jnp.asarray(self._hull_cvx),
                jnp.asarray(self._hull_ccv),
                jnp.asarray(self._hull_fresh),
            )
        return self._hull_dev

    # -- intensity sidecar (cfg.map.carry_intensity) ------------------------
    def _carry_intensity(self, points: np.ndarray) -> bool:
        return bool(self.cfg.map.carry_intensity) and points.shape[1] >= 4

    def _reduce_xyzi(self, points: np.ndarray) -> np.ndarray:
        from direct_lidar_odometry_tpu.io import hostprep

        p = self.cfg.preprocessing
        return hostprep.reduce_keyframe_scan_xyzi(
            points,
            p.crop.size if p.crop.use else None,
            p.voxel_scan.res if p.voxel_scan.use else None,
            p.voxel_submap.res if p.voxel_submap.use else None,
            self.cfg.shapes.n_keyframe,
        )

    def _resolve_intensity(self, force: bool = False) -> None:
        """Consume pending (result, scan) pairs whose keyframe decision is
        known; keep the sidecar ring in sync with device eviction via
        FrameResult.kf_slot. Only blocks when ``force`` or when the pending
        queue exceeds its bound — and then only on the OLDEST entries,
        whose results are long since computed under pipelined dispatch."""
        keep = []
        overflow = len(self._ipending) - self._ipending_max
        for n, (res, idx, scan) in enumerate(self._ipending):
            ready = force or n < overflow
            if not ready:
                flag = res.new_keyframe
                ready = not hasattr(flag, "is_ready") or flag.is_ready()
            if not ready:
                keep.append((res, idx, scan))
                continue
            nk = np.asarray(res.new_keyframe)
            slot = np.asarray(res.kf_slot)
            if idx is not None:
                nk, slot = nk[idx], slot[idx]
            if bool(nk):
                self._ikf[int(slot)] = self._reduce_xyzi(scan)
        self._ipending = keep

    def build_map_xyzi(self) -> np.ndarray:
        """Intensity-carrying map ([P, 4] xyzi), from the host sidecar +
        the CURRENT device keyframe poses (so loop-closure re-anchoring is
        reflected). Requires cfg.map.carry_intensity and [N, 4] scans fed
        through process_scan/process_chunk."""
        assert self.state is not None
        self._resolve_intensity(force=True)
        return mapper.build_map_xyzi(
            self._ikf,
            np.asarray(self.state.keyframes.positions),
            np.asarray(self.state.keyframes.quats),
            self.cfg.map.leaf_size,
        )

    # -- loop closure / map refinement -------------------------------------
    def maybe_refine(self, force: bool = False) -> dict | None:
        """Run a loop-closure + pose-graph refinement round if due.

        Due = at least ``posegraph.refine_every_kf`` keyframes were added
        since the last round (``force=True`` skips that gate) and enough
        keyframes exist to admit a loop (min_index_gap). Re-anchors the
        live state (keyframe ring, clouds, current pose, cached submap);
        returns a diagnostics dict, or None when skipped. Capability the
        reference lacks entirely (SURVEY.md §5).
        """
        cfg = self.cfg
        if self.state is None:
            return None
        n_kf = int(self.state.keyframes.count)
        if n_kf < cfg.posegraph.min_index_gap + 2:
            return None
        if not force and (n_kf - self._kf_at_refine) < cfg.posegraph.refine_every_kf:
            return None
        t0 = time.perf_counter()
        self.state, info = self.refine_fn()(self.state)
        self._kf_at_refine = n_kf
        entry = {
            "frame": len(self.poses),
            "n_keyframes": n_kf,
            "n_candidates": int(info.n_candidates),
            "n_accepted": int(info.n_accepted),
            "graph_error": float(info.graph_error),
            "max_correction_m": float(info.max_correction),
            "wall_ms": (time.perf_counter() - t0) * 1e3,
        }
        self.refine_log.append(entry)
        return entry

    def refine_fn(self):
        """The jitted loop-closure + refinement program (built once)."""
        if self._refine_fn is None:
            import jax

            from direct_lidar_odometry_tpu.utils.precision import f32_matmuls

            cfg = self.cfg
            backend = resolve_backend(cfg)
            # f32_matmuls is NOT optional here: reduced-precision matmuls
            # (bf16, or TF32 on a GPU) corrupt the chain relative poses by
            # decimeters at map-scale translations and the measured loop
            # rotations by degrees, and the refinement then makes the
            # keyframe map worse instead of repairing it
            self._refine_fn = jax.jit(f32_matmuls(
                lambda st: loopclosure.refine_and_reanchor(st, cfg, backend)
            ))
        return self._refine_fn

    # -- health -----------------------------------------------------------
    def health_check(self, result: FrameResult, min_corr_frac: float = 0.05):
        """Classify a frame from its health metrics (SURVEY §5 gap: the
        reference only prints "lm not converged!!" and carries on,
        lsq_registration_impl.hpp:105-108).

        Returns one of:
          "ok"        — normal frame
          "degraded"  — solver failed to converge or correspondence count
                        below ``min_corr_frac`` of the scan capacity
                        (tracking at risk; consider checkpointing)
          "diverged"  — non-finite pose or zero S2M correspondences (the
                        pipeline already fell back to the S2S-propagated
                        pose; restart from a checkpoint to recover)

        Accepts either a per-frame result or the stacked [K, ...] result
        from :meth:`process_chunk` — a stacked result is classified by its
        WORST frame. Calling this synchronizes the frame(s).
        """
        pose = np.asarray(result.pose)
        s2m_nc = np.atleast_1d(np.asarray(result.s2m_num_corr))
        s2s_nc = np.atleast_1d(np.asarray(result.s2s_num_corr))
        s2s_conv = np.atleast_1d(np.asarray(result.s2s_converged))
        if not np.all(np.isfinite(pose)) or int(s2m_nc.min()) == 0:
            return "diverged"
        n_cap = self.cfg.shapes.n_scan
        weak = (
            int(s2s_nc.min()) < min_corr_frac * n_cap
            or int(s2m_nc.min()) < min_corr_frac * n_cap
        )
        if not bool(s2s_conv.all()) or weak:
            return "degraded"
        return "ok"

    # -- outputs ----------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        if not self.poses:
            return np.zeros((0, 4, 4))
        # single device->host materialization for the whole trajectory
        return np.asarray(jnp.stack(self.poses))

    def build_map(self, out_capacity: int | None = None) -> np.ndarray:
        assert self.state is not None
        m = mapper.build_map(self.state.keyframes, self.cfg.map.leaf_size, out_capacity)
        return cl.to_numpy(m)

    def num_keyframes(self) -> int:
        return int(self.state.keyframes.count) if self.state is not None else 0
