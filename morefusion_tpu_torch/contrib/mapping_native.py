"""ctypes bindings for the C++ occupancy-mapping backend.

Own copy of ``morefusion_tpu/contrib/mapping_native.py``.
``NativeMultiInstanceMapping`` mirrors the NumPy
``MultiInstanceOccupancyMapping`` API (its correctness oracle) and adds the
real-time pieces the reference keeps in C++ (``OctomapServer.cpp``): exact
DDA ray carving and raycast label/depth rendering.

The library is built from ``csrc/mapping.cpp`` with ``g++ -O3 -march=native
-fopenmp`` at first use into ``_build/libmfm.so`` beside the package, and
rebuilt when the source is newer than it. A failed build raises with the
compiler's output: nothing falls back to the NumPy mapping.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mapping.cpp"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libmfm.so"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def build() -> float:
    """Compile ``SOURCE`` into ``LIB_PATH``; returns the seconds it took.

    Raises ``RuntimeError`` carrying g++'s output on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def stale() -> bool:
    """Whether ``LIB_PATH`` is missing or older than its source."""
    return (not LIB_PATH.exists()
            or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime)


def load_library():
    """The native library, built first if missing or stale."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))

        f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        h, c_int, c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mfm_create.restype = h
        lib.mfm_create.argtypes = []
        lib.mfm_destroy.argtypes = [h]
        lib.mfm_destroy.restype = None
        lib.mfm_initialize.argtypes = [h, c_int, ctypes.c_double]
        lib.mfm_initialize.restype = c_int
        lib.mfm_num_voxels.argtypes = [h, c_int]
        lib.mfm_num_voxels.restype = c_i64
        lib.mfm_num_instances.argtypes = [h]
        lib.mfm_num_instances.restype = c_int
        lib.mfm_instance_ids.argtypes = [h, ctypes.POINTER(c_int)]
        lib.mfm_instance_ids.restype = None
        lib.mfm_integrate.argtypes = [h, c_int, f32, c_i64, f64, c_int]
        lib.mfm_integrate.restype = c_int
        lib.mfm_update.argtypes = [h, c_int, f32, c_i64]
        lib.mfm_update.restype = c_int
        lib.mfm_query.argtypes = [h, c_int, f64, c_i64, f32]
        lib.mfm_query.restype = c_int
        lib.mfm_get_target_grids.argtypes = [
            h, c_int, i64, ctypes.c_double, f64, f32, f32, f32,
        ]
        lib.mfm_get_target_grids.restype = c_int
        lib.mfm_get_target_grids_batch.argtypes = [
            h, i32, c_i64, i64, f64, f64, f32, f32, f32,
        ]
        lib.mfm_get_target_grids_batch.restype = c_int
        lib.mfm_extract_points.argtypes = [h, c_int, c_int, f64, c_i64]
        lib.mfm_extract_points.restype = c_i64
        lib.mfm_render.argtypes = [
            h, f64, f64, c_int, c_int, ctypes.c_double, i32, f32,
        ]
        lib.mfm_render.restype = c_int
        lib.mfm_reset.argtypes = [h]
        lib.mfm_reset.restype = c_int
        _LIB = lib
        return _LIB


class NativeMultiInstanceMapping:
    """C++-backed multi-instance occupancy mapping (OctomapServer core)."""

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.mfm_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mfm_destroy(self._h)
            self._h = None

    @property
    def instance_ids(self):
        n = self._lib.mfm_num_instances(self._h)
        buf = (ctypes.c_int * max(n, 1))()
        self._lib.mfm_instance_ids(self._h, buf)
        return [buf[i] for i in range(n)]

    def initialize(self, instance_id: int, *, pitch: float):
        rc = self._lib.mfm_initialize(self._h, int(instance_id), float(pitch))
        if rc != 0:
            raise ValueError(f"instance {instance_id} already exists")

    def integrate(
        self, instance_id, mask, pcd, origin=(0, 0, 0), carve: bool = True
    ):
        nonnan = ~np.isnan(pcd).any(axis=2)
        points = np.ascontiguousarray(
            pcd[mask & nonnan], dtype=np.float32
        )
        origin = np.ascontiguousarray(origin, dtype=np.float64)
        self._lib.mfm_integrate(
            self._h, int(instance_id), points, len(points), origin,
            int(carve),
        )

    def update(self, instance_id, occupied):
        pts = np.ascontiguousarray(occupied, dtype=np.float32)
        self._lib.mfm_update(self._h, int(instance_id), pts, len(pts))

    def query_probability(self, instance_id, points) -> np.ndarray:
        pts = np.ascontiguousarray(points, dtype=np.float64)
        out = np.empty(len(pts), np.float32)
        self._lib.mfm_query(self._h, int(instance_id), pts, len(pts), out)
        return out

    def num_voxels(self, instance_id) -> int:
        return int(self._lib.mfm_num_voxels(self._h, int(instance_id)))

    def get_target_grids(
        self, target_id, *, dimensions, pitch, origin
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        dims = np.ascontiguousarray(dimensions, dtype=np.int64)
        origin = np.ascontiguousarray(origin, dtype=np.float64)
        shape = tuple(int(d) for d in dimensions)
        g_t = np.zeros(shape, np.float32)
        g_n = np.zeros(shape, np.float32)
        g_e = np.zeros(shape, np.float32)
        self._lib.mfm_get_target_grids(
            self._h, int(target_id), dims, float(pitch), origin,
            g_t.reshape(-1), g_n.reshape(-1), g_e.reshape(-1),
        )
        return g_t, g_n, g_e

    def get_target_grids_batch(
        self, target_ids, *, dimensions, pitches, origins
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(N, X, Y, Z) target/nontarget/empty grids in one native call."""
        ids = np.ascontiguousarray(target_ids, dtype=np.int32)
        n = len(ids)
        dims = np.ascontiguousarray(dimensions, dtype=np.int64)
        pitches = np.ascontiguousarray(pitches, dtype=np.float64)
        origins = np.ascontiguousarray(origins, dtype=np.float64)
        if pitches.shape != (n,) or origins.shape != (n, 3):
            raise ValueError(f"{n} ids need ({n},) pitches and ({n}, 3) "
                             f"origins, got {pitches.shape}, "
                             f"{origins.shape}")
        shape = (n,) + tuple(int(d) for d in dimensions)
        g_t = np.zeros(shape, np.float32)
        g_n = np.zeros(shape, np.float32)
        g_e = np.zeros(shape, np.float32)
        self._lib.mfm_get_target_grids_batch(
            self._h, ids, n, dims, pitches, origins.reshape(-1),
            g_t.reshape(n, -1), g_n.reshape(n, -1), g_e.reshape(n, -1),
        )
        return g_t, g_n, g_e

    def get_target_pcds(
        self, target_id, aabb_min=None, aabb_max=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = self.num_voxels(target_id)
        out = []
        for occ in (1, 0):
            buf = np.zeros((max(n, 1), 3), np.float64)
            k = self._lib.mfm_extract_points(
                self._h, int(target_id), occ, buf.reshape(-1), n
            )
            pts = buf[: max(k, 0)]
            if aabb_min is not None:
                pts = pts[(pts >= aabb_min).all(axis=1)]
            if aabb_max is not None:
                pts = pts[(pts < aabb_max).all(axis=1)]
            out.append(pts)
        return out[0], out[1]

    def render(
        self,
        K: np.ndarray,
        T_cam2world: np.ndarray,
        shape: Tuple[int, int],
        max_range: float = 3.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Raycast all maps -> (instance_label (H, W) int32 with -2 = no
        hit, depth (H, W) float32 NaN holes)."""
        H, W = shape
        label = np.full((H, W), -2, np.int32)
        depth = np.full((H, W), np.nan, np.float32)
        self._lib.mfm_render(
            self._h,
            np.ascontiguousarray(K, np.float64).reshape(-1),
            np.ascontiguousarray(T_cam2world, np.float64).reshape(-1),
            H, W, float(max_range),
            label.reshape(-1), depth.reshape(-1),
        )
        return label, depth

    def reset(self):
        self._lib.mfm_reset(self._h)
