"""ctypes bindings for the native host runtime (port of
lis_slam_tpu/runtime/native.py): the KITTI .bin reader, the range gate,
the host voxel filter and the multithreaded scan prefetcher of
csrc/host/lis_host.cpp.

The library is built with the host C++ compiler at first use into
`lis_slam_torch/_build/` (git-ignored), under a name that carries a hash
of the source and the flags, so an edited source rebuilds. Every entry
point keeps the JAX module's numpy fallback for a machine without a
compiler; the fallback loader, as the JAX module's, reads scans without
the range gate (`min_range`/`max_range` are ignored there).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "lis_host.cpp"
BUILD_DIR = _PKG / "_build"
# the flags of native/Makefile
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_F32P = ctypes.POINTER(ctypes.c_float)


def _compiler() -> str | None:
    return shutil.which("c++") or shutil.which("g++")


def lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblis_host_{digest}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    lib.lis_read_bin.restype = i64
    lib.lis_read_bin.argtypes = [ctypes.c_char_p, _F32P, i64]
    lib.lis_range_filter.restype = i64
    lib.lis_range_filter.argtypes = [_F32P, i64, ctypes.c_float,
                                     ctypes.c_float]
    lib.lis_voxel_filter.restype = i64
    lib.lis_voxel_filter.argtypes = [_F32P, i64, ctypes.c_float, _F32P, i64]
    lib.lis_loader_create.restype = ctypes.c_void_p
    lib.lis_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64,
                                      i64, i64, i64, ctypes.c_float,
                                      ctypes.c_float]
    lib.lis_loader_pop.restype = i64
    lib.lis_loader_pop.argtypes = [ctypes.c_void_p, _F32P,
                                   ctypes.POINTER(i64)]
    lib.lis_loader_remaining.restype = i64
    lib.lis_loader_remaining.argtypes = [ctypes.c_void_p]
    lib.lis_loader_destroy.restype = None
    lib.lis_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def _load() -> ctypes.CDLL | None:
    """Build (once per source + flags) and load the library; None when
    there is no compiler or the build fails."""
    lib = lib_path()
    if not lib.exists():
        cxx = _compiler()
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return None
        os.replace(tmp, lib)
    try:
        return _bind(ctypes.CDLL(str(lib)))
    except OSError:
        return None


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def read_bin(path: str, max_points: int) -> np.ndarray:
    """(n, 4) float32 xyzi of a KITTI .bin, at most max_points rows."""
    lib = _load()
    if lib is None:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:max_points]
    buf = np.empty((max_points, 4), np.float32)
    n = lib.lis_read_bin(path.encode(), _ptr(buf), max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return buf[:n]


def range_filter(pts: np.ndarray, min_range: float, max_range: float):
    """Rows with finite xyz and min_range^2 <= r^2 <= max_range^2 (and
    r^2 > 1e-6), in order (removeClosedPointCloud)."""
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        r2 = np.sum(pts[:, :3] ** 2, axis=1)
        keep = (np.isfinite(pts).all(1) & (r2 >= min_range ** 2)
                & (r2 <= max_range ** 2) & (r2 > 1e-6))
        return pts[keep]
    n = lib.lis_range_filter(_ptr(pts), len(pts), min_range, max_range)
    return pts[:n]


def voxel_filter(pts: np.ndarray, leaf: float) -> np.ndarray:
    """The first point of each voxel of side `leaf`, in order (xyz)."""
    lib = _load()
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    if lib is None:
        cells = np.floor(pts / leaf).astype(np.int64)
        _, idx = np.unique(cells, axis=0, return_index=True)
        return pts[np.sort(idx)]
    out = np.empty_like(pts)
    n = lib.lis_voxel_filter(_ptr(pts), len(pts), leaf, _ptr(out), len(pts))
    return out[:n]


class AsyncScanLoader:
    """Multithreaded .bin prefetcher: yields (buffer (max_points, 4)
    float32 zero-padded, count) per file, in file order (scans popped out
    of order wait in a reorder buffer)."""

    def __init__(self, files: list[str], max_points: int, capacity: int = 20,
                 n_threads: int = 2, min_range: float = 0.0,
                 max_range: float = 1e9):
        self.files = list(files)
        self.max_points = max_points
        self._lib = _load()
        self._pending: dict[int, tuple[np.ndarray, int]] = {}
        self._next = 0
        self._handle = None
        if self._lib is None:
            return
        self._paths = (ctypes.c_char_p * len(self.files))(
            *[f.encode() for f in self.files])
        self._handle = self._lib.lis_loader_create(
            self._paths, len(self.files), max_points, capacity, n_threads,
            min_range, max_range)

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:  # numpy fallback (or closed), in order
            if self._next >= len(self.files):
                raise StopIteration
            pts = read_bin(self.files[self._next], self.max_points)
            self._next += 1
            buf = np.zeros((self.max_points, 4), np.float32)
            buf[:len(pts)] = pts
            return buf, len(pts)
        while self._next not in self._pending:
            buf = np.empty((self.max_points, 4), np.float32)
            idx = ctypes.c_int64(-1)
            n = self._lib.lis_loader_pop(self._handle, _ptr(buf),
                                         ctypes.byref(idx))
            if n < 0:
                if self._next < len(self.files) and self._pending:
                    continue
                raise StopIteration
            self._pending[int(idx.value)] = (buf, int(n))
        out = self._pending.pop(self._next)
        self._next += 1
        return out

    def close(self):
        if self._handle is not None:
            self._lib.lis_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
