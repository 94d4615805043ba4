"""ctypes bindings for the native host runtime (cpp/libdlo_host.so).

Provides fast scan loading/preprocessing and a background prefetcher that
overlaps disk IO + host preprocessing with device compute — the native
counterpart the reference gets from its all-C++ process (SURVEY.md §2).
Falls back gracefully (``available() -> False``) when the library has not
been built (``make -C cpp``); callers then use the NumPy/JAX paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "cpp", "libdlo_host.so")
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path):
        try:  # best-effort build of the library alone (the C++ baseline
            # target needs OpenMP, which a host may lack)
            subprocess.run(
                ["make", "-C", os.path.dirname(path), "libdlo_host.so"],
                check=True, capture_output=True, timeout=120,
            )
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.dlo_read_velodyne.restype = ctypes.c_int64
    lib.dlo_read_velodyne.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.dlo_preprocess.restype = ctypes.c_int64
    lib.dlo_preprocess.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.dlo_preprocess_morton.restype = ctypes.c_int64
    lib.dlo_preprocess_morton.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.dlo_quantize.restype = ctypes.c_int64
    lib.dlo_quantize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.dlo_feeder_create.restype = ctypes.c_void_p
    lib.dlo_feeder_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int64]
    lib.dlo_feeder_next.restype = ctypes.c_int64
    lib.dlo_feeder_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.dlo_feeder_destroy.restype = None
    lib.dlo_feeder_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_velodyne(path: str, max_points: int = 1 << 20) -> np.ndarray:
    lib = _load()
    assert lib is not None, "native library unavailable (make -C cpp)"
    out = np.empty((max_points, 3), np.float32)
    n = lib.dlo_read_velodyne(path.encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return out[:n].copy()


def preprocess(
    points: np.ndarray, crop_size: float = 1.0, res: float = 0.25,
    out_cap: int = 1 << 17,
) -> np.ndarray:
    """NaN + inverse-crop + centroid voxel filter (native)."""
    lib = _load()
    assert lib is not None, "native library unavailable (make -C cpp)"
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.empty((out_cap, 3), np.float32)
    n = lib.dlo_preprocess(
        _fptr(pts), len(pts), ctypes.c_float(crop_size), ctypes.c_float(res),
        _fptr(out), out_cap,
    )
    return out[:n].copy()


def preprocess_morton(
    points: np.ndarray, crop_size: float, res: float, out_cap: int
) -> np.ndarray:
    """NaN + inverse-crop + centroid voxel filter, Z-ordered output.

    Host-side twin of ``ops.voxel.voxel_downsample_morton`` (same voxel
    grouping, same Morton order, same Bresenham overflow policy) so the
    device step can skip preprocessing entirely — see
    ``DloConfig.host_preprocess``.
    """
    lib = _load()
    assert lib is not None, "native library unavailable (make -C cpp)"
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    out = np.empty((out_cap, 3), np.float32)
    n = lib.dlo_preprocess_morton(
        _fptr(pts), len(pts), ctypes.c_float(crop_size), ctypes.c_float(res),
        _fptr(out), out_cap,
    )
    return out[:n].copy()


def quantize(points: np.ndarray, capacity: int):
    """uint16 wire-format encode (see core/cloud.py QuantizedScan).

    Threaded C++, releases the GIL — ~10x the numpy encode on this host,
    and overlappable with device dispatch from a Python thread. Returns
    (q [capacity,3] u16, lo [3] f32, scale [3] f32, count int32).
    """
    lib = _load()
    assert lib is not None, "native library unavailable (make -C cpp)"
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    q = np.empty((capacity, 3), np.uint16)
    lo = np.empty(3, np.float32)
    scale = np.empty(3, np.float32)
    m = lib.dlo_quantize(
        _fptr(pts), len(pts), capacity,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        _fptr(lo), _fptr(scale),
    )
    return q, lo, scale, np.int32(m)


class ScanFeeder:
    """Background scan prefetcher over a list of .bin files.

    Iterates (index, points) with IO + preprocessing overlapped one or
    more scans ahead of the consumer.
    """

    def __init__(self, files: list[str], cap: int = 1 << 17,
                 crop_size: float = 1.0, res: float = 0.25, depth: int = 4):
        lib = _load()
        assert lib is not None, "native library unavailable (make -C cpp)"
        self._lib = lib
        self._cap = cap
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._n = len(files)
        self._handle = lib.dlo_feeder_create(
            arr, len(files), cap, ctypes.c_float(crop_size),
            ctypes.c_float(res), depth,
        )
        self._buf = np.empty((cap, 3), np.float32)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        n = self._lib.dlo_feeder_next(self._handle, _fptr(self._buf))
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError(f"scan {self._i} failed to read")
        i = self._i
        self._i += 1
        return i, self._buf[:n].copy()

    def close(self):
        if self._handle:
            self._lib.dlo_feeder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
