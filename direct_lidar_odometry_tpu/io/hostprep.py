"""Host-side scan preprocessing (NaN/crop/voxel/Morton), native or numpy.

When ``DloConfig.host_preprocess`` is on, the runner preprocesses each
scan on the host BEFORE transfer instead of on the device: the device
step then starts from ~n_scan voxel centroids already in Z-order, which
removes the per-frame 131k-point sort from the device step and shrinks
the wire format ~4x. The host work runs
in the runner's existing prep worker thread (GIL-releasing C++), so it
overlaps device compute — the same division of labor as the reference,
whose preprocessing (``odom.cc:443-465``) also runs on the CPU that
feeds the registration.

Prefers the threaded C++ implementation (cpp/dlo_host.cpp
``dlo_preprocess_morton``); falls back to a vectorized numpy twin when
the native library is unavailable.
"""

from __future__ import annotations

import numpy as np

from direct_lidar_odometry_tpu.io import native

_GRID_DIM = 1024


def _part_bits_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(1023)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def _preprocess_morton_numpy(
    points: np.ndarray, crop_size: float, res: float, out_cap: int
) -> np.ndarray:
    pts = np.asarray(points[:, :3], np.float32)
    keep = np.all(np.isfinite(pts), axis=1)
    if crop_size > 0:
        keep &= ~np.all(np.abs(pts) <= crop_size, axis=1)
    pts = pts[keep]
    if len(pts) == 0:
        return np.zeros((0, 3), np.float32)
    origin = pts.min(axis=0)
    coords = np.clip(
        np.floor((pts - origin) / res).astype(np.int64), 0, _GRID_DIM - 1
    ).astype(np.uint32)
    code = (
        _part_bits_np(coords[:, 0])
        | (_part_bits_np(coords[:, 1]) << 1)
        | (_part_bits_np(coords[:, 2]) << 2)
    )
    # np.unique sorts ascending = Morton order
    uniq, inv = np.unique(code, return_inverse=True)
    s = len(uniq)
    sums = np.zeros((s, 3), np.float64)
    np.add.at(sums, inv, pts)
    counts = np.bincount(inv, minlength=s).astype(np.float64)
    centroids = (sums / counts[:, None]).astype(np.float32)
    if s <= out_cap:
        return centroids
    # Bresenham stride along the Z-curve (matches ops/voxel.py and the C++)
    i = np.arange(s, dtype=np.uint64)
    kept = (i * np.uint64(out_cap)) % np.uint64(s) < np.uint64(out_cap)
    return centroids[kept]


def preprocess_morton(
    points: np.ndarray, crop_size: float | None, res: float, out_cap: int
) -> np.ndarray:
    """[M, 3+] raw scan -> [<=out_cap, 3] Z-ordered voxel centroids."""
    crop = float(crop_size) if crop_size else 0.0
    if native.available():
        return native.preprocess_morton(points, crop, res, out_cap)
    return _preprocess_morton_numpy(points, crop, res, out_cap)


def voxel_mean_xyzi(pts: np.ndarray, res: float, out_cap: int | None = None) -> np.ndarray:
    """[M, 4] xyzi -> [S, 4] per-voxel mean of coordinates AND intensity.

    Offline/export twin of ops/voxel.py with the intensity channel riding
    as a payload (the reference gets this for free from pcl::VoxelGrid
    averaging every PointXYZI field, dlo/dlo.h:50). Morton output order;
    capacity overflow uses the same Bresenham Z-curve stride as the device
    kernel so the kept subset is spatially uniform.
    """
    pts = np.asarray(pts, np.float32)
    if len(pts) == 0:
        return pts.reshape(0, 4)
    xyz = pts[:, :3]
    origin = xyz.min(axis=0)
    coords = np.clip(
        np.floor((xyz - origin) / res).astype(np.int64), 0, _GRID_DIM - 1
    ).astype(np.uint32)
    code = (
        _part_bits_np(coords[:, 0])
        | (_part_bits_np(coords[:, 1]) << 1)
        | (_part_bits_np(coords[:, 2]) << 2)
    )
    uniq, inv = np.unique(code, return_inverse=True)
    s = len(uniq)
    sums = np.zeros((s, 4), np.float64)
    np.add.at(sums, inv, pts[:, :4])
    counts = np.bincount(inv, minlength=s).astype(np.float64)
    out = (sums / counts[:, None]).astype(np.float32)
    if out_cap is not None and s > out_cap:
        i = np.arange(s, dtype=np.uint64)
        kept = (i * np.uint64(out_cap)) % np.uint64(s) < np.uint64(out_cap)
        out = out[kept]
    return out


def reduce_keyframe_scan_xyzi(
    points: np.ndarray, crop_size: float | None, scan_res: float | None,
    submap_res: float | None, out_cap: int,
) -> np.ndarray:
    """Raw [M, 4] xyzi scan -> the keyframe-cloud reduction, intensity kept.

    Mirrors the geometry path of a stored keyframe cloud (NaN/crop ->
    scan-res voxel -> submap-res voxel, pipeline.preprocess_scan +
    keyframes.make_keyframe_cloud) so the runner's host intensity sidecar
    stays the same density as the device keyframe ring.
    """
    pts = np.asarray(points, np.float32)
    if pts.shape[1] < 4:
        pts = np.concatenate(
            [pts[:, :3], np.zeros((len(pts), 1), np.float32)], axis=1
        )
    keep = np.all(np.isfinite(pts[:, :3]), axis=1)
    if crop_size:
        keep &= ~np.all(np.abs(pts[:, :3]) <= float(crop_size), axis=1)
    pts = pts[keep][:, :4]
    if scan_res:
        pts = voxel_mean_xyzi(pts, scan_res)
    if submap_res:
        pts = voxel_mean_xyzi(pts, submap_res, out_cap=out_cap)
    elif len(pts) > out_cap:
        pts = pts[:out_cap]
    return pts
