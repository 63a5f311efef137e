"""Multi-instance occupancy mapping: sparse voxel-hash log-odds fusion.

Own copy of ``morefusion_tpu/contrib/occupancy_mapping.py`` (NumPy). It
replaces the reference's octomap-backed mapping twins
(``morefusion/contrib/multi_instance_octree_mapping.py:6-125`` offline and
the C++ ``OctomapServer.cpp`` online): each instance owns a sparse voxel
map keyed by packed integer coordinates; integration inserts measured
endpoints as occupied hits and carves free space along camera rays
(vectorized ray-marching, the octree's insertPointCloud equivalent).
The C++ backend (``csrc/mapping.cpp``, bound by ``mapping_native.py``)
accelerates the same data structure for the real-time path; this NumPy
version is the reference implementation it is tested against.

Log-odds update follows the octomap defaults: hit +0.85, miss -0.4,
clamped to [-2, 3.5]; occupancy probability = sigmoid(logodds).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_OFFSET = 1 << 20  # makes quantized coords positive for packing
_HIT = 0.85
_MISS = -0.4
_CLAMP_MIN = -2.0
_CLAMP_MAX = 3.5


def _pack(ijk: np.ndarray) -> np.ndarray:
    """(N, 3) int voxel coords -> (N,) int64 keys (21 bits/axis)."""
    q = ijk.astype(np.int64) + _OFFSET
    return (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]


def _unpack(keys: np.ndarray) -> np.ndarray:
    mask = (1 << 21) - 1
    i = (keys >> 42) & mask
    j = (keys >> 21) & mask
    k = keys & mask
    return np.stack([i, j, k], axis=1) - _OFFSET


class SparseVoxelMap:
    """Sorted-key sparse log-odds voxel map."""

    def __init__(self, pitch: float):
        self.pitch = float(pitch)
        self.keys = np.empty((0,), dtype=np.int64)
        self.logodds = np.empty((0,), dtype=np.float32)

    def _quantize(self, points: np.ndarray) -> np.ndarray:
        return np.floor(points / self.pitch).astype(np.int64)

    def update(self, points: np.ndarray, delta: float) -> None:
        """Accumulate ``delta`` log-odds into the voxels containing points."""
        if len(points) == 0:
            return
        new_keys = _pack(self._quantize(points))
        # per-voxel accumulation (octomap updates once per ray per voxel;
        # we accumulate per unique voxel of this batch once, like its
        # discrete-update mode)
        uniq = np.unique(new_keys)
        self.update_keys(uniq, delta)

    def update_keys(self, uniq_keys: np.ndarray, delta) -> None:
        merged = np.union1d(self.keys, uniq_keys)
        lo = np.zeros(len(merged), dtype=np.float32)
        pos_old = np.searchsorted(merged, self.keys)
        lo[pos_old] = self.logodds
        pos_new = np.searchsorted(merged, uniq_keys)
        lo[pos_new] = np.clip(lo[pos_new] + delta, _CLAMP_MIN, _CLAMP_MAX)
        self.keys = merged
        self.logodds = lo

    def query_logodds(self, points: np.ndarray) -> np.ndarray:
        """Log-odds at points; NaN where unknown."""
        out = np.full(len(points), np.nan, dtype=np.float32)
        if len(self.keys) == 0 or len(points) == 0:
            return out
        q = _pack(self._quantize(points))
        pos = np.searchsorted(self.keys, q)
        pos = np.clip(pos, 0, len(self.keys) - 1)
        hit = self.keys[pos] == q
        out[hit] = self.logodds[pos[hit]]
        return out

    def query_probability(self, points: np.ndarray) -> np.ndarray:
        """Occupancy probability at points; -1 where unknown."""
        lo = self.query_logodds(points)
        prob = 1.0 / (1.0 + np.exp(-lo))
        prob[np.isnan(lo)] = -1.0
        return prob

    def occupied_points(self, threshold: float = 0.5) -> np.ndarray:
        lo_thresh = np.log(threshold / (1.0 - threshold))
        keys = self.keys[self.logodds >= lo_thresh]
        return (_unpack(keys) + 0.5) * self.pitch

    def empty_points(self, threshold: float = 0.5) -> np.ndarray:
        lo_thresh = np.log(threshold / (1.0 - threshold))
        keys = self.keys[self.logodds < lo_thresh]
        return (_unpack(keys) + 0.5) * self.pitch


def _ray_free_voxels(
    origin: np.ndarray, endpoints: np.ndarray, pitch: float, max_steps: int = 256
) -> np.ndarray:
    """Unique packed voxel keys along [origin, endpoint) rays (endpoint
    voxel excluded). Vectorized sampling at half-pitch steps."""
    vec = endpoints - origin[None, :]
    dist = np.linalg.norm(vec, axis=1)
    n_steps = np.minimum(
        np.ceil(dist / (0.5 * pitch)).astype(int), max_steps
    )
    max_n = int(n_steps.max(initial=0))
    if max_n <= 1:
        return np.empty((0,), dtype=np.int64)
    # parametric samples t in (0, 1), excluding the endpoint voxel
    t = (np.arange(max_n)[None, :] + 0.5) / n_steps[:, None]  # (N, max_n)
    valid = t < 1.0 - (0.5 * pitch) / np.maximum(dist, 1e-9)[:, None]
    pts = origin[None, None, :] + t[:, :, None] * vec[:, None, :]
    pts = pts[valid]
    if len(pts) == 0:
        return np.empty((0,), dtype=np.int64)
    keys = _pack(np.floor(pts / pitch).astype(np.int64))
    # drop endpoint voxels to avoid immediately erasing hits
    end_keys = _pack(np.floor(endpoints / pitch).astype(np.int64))
    keys = np.setdiff1d(np.unique(keys), np.unique(end_keys))
    return keys


class MultiInstanceOccupancyMapping:
    """Dict of instance_id -> SparseVoxelMap, reference-compatible API."""

    def __init__(self):
        self._maps: Dict[int, SparseVoxelMap] = {}

    @property
    def instance_ids(self):
        return list(self._maps.keys())

    def initialize(self, instance_id, *, pitch: float):
        if instance_id in self._maps:
            raise ValueError(f"instance {instance_id} already exists")
        self._maps[instance_id] = SparseVoxelMap(pitch)

    def integrate(
        self,
        instance_id,
        mask: np.ndarray,
        pcd: np.ndarray,
        origin=(0, 0, 0),
        carve: bool = True,
    ):
        """Insert a masked organized point cloud (camera at ``origin``)."""
        m = self._maps[instance_id]
        nonnan = ~np.isnan(pcd).any(axis=2)
        points = pcd[mask & nonnan]
        if len(points) == 0:
            return
        origin = np.asarray(origin, dtype=float)
        hits = np.unique(_pack(m._quantize(points)))
        m.update_keys(hits, _HIT)
        if carve:
            free = _ray_free_voxels(origin, points, m.pitch)
            free = np.setdiff1d(free, hits)
            if len(free):
                m.update_keys(free, _MISS)

    def update(self, instance_id, occupied: np.ndarray):
        """Force-mark points as occupied (CAD-model injection,
        reference ``update``/``updateNodes``)."""
        m = self._maps[instance_id]
        m.update(occupied, _CLAMP_MAX)

    def get_target_grids(
        self, target_id, *, dimensions, pitch, origin
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample all maps at the grid's voxel centers.

        Returns (grid_target, grid_nontarget, grid_empty) probability
        grids, exactly the reference contract
        (``multi_instance_octree_mapping.py:35-94``).
        """
        origin = np.asarray(origin, dtype=float)
        assert not np.isnan(origin).any()
        X, Y, Z = dimensions

        ii, jj, kk = np.meshgrid(
            np.arange(X), np.arange(Y), np.arange(Z), indexing="ij"
        )
        centers = (
            np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) * pitch + origin
        )

        grid_target = np.zeros(dimensions, dtype=np.float32).reshape(-1)
        grid_nontarget = np.zeros_like(grid_target)
        grid_empty = np.zeros_like(grid_target)

        for ins_id, m in self._maps.items():
            occ = m.query_probability(centers)
            q = occ >= 0.5
            if ins_id == target_id:
                grid_target[q] = occ[q]
            else:
                grid_nontarget[q] = np.maximum(grid_nontarget[q], occ[q])
            q = (occ >= 0) & (occ < 0.5)
            grid_empty[q] = np.maximum(grid_empty[q], 1.0 - occ[q])

        return (
            grid_target.reshape(dimensions),
            grid_nontarget.reshape(dimensions),
            grid_empty.reshape(dimensions),
        )

    def get_target_pcds(
        self, target_id, aabb_min=None, aabb_max=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(occupied, empty) voxel-center point clouds of one instance."""
        m = self._maps[target_id]
        occupied = m.occupied_points()
        empty = m.empty_points()
        if aabb_min is not None:
            occupied = occupied[(occupied >= aabb_min).all(axis=1)]
            empty = empty[(empty >= aabb_min).all(axis=1)]
        if aabb_max is not None:
            occupied = occupied[(occupied < aabb_max).all(axis=1)]
            empty = empty[(empty < aabb_max).all(axis=1)]
        return occupied, empty
