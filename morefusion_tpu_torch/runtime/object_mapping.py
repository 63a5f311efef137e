"""Temporal pose fusion: n-vote consistency spawning.

Own copy of ``morefusion_tpu/runtime/object_mapping.py``, on the port's
``metrics.average_distance`` (scipy's ``cKDTree``). Port of the
reference's ``object_mapping`` node
(``ros/src/morefusion_ros/nodes/object_mapping.py:23-240``): each instance
keeps a deque of its last 6 predicted poses; it "spawns" (becomes a stable
mapped object) once >= n_votes-1 of the previous poses agree with the
latest one within the ADD(-S) threshold (0.02 m asymmetric / 0.01 m
symmetric). Spawned objects stop consuming new poses.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

from ..metrics import average_distance


class ObjectTrack:
    _add_threshold = 0.02
    _adds_threshold = 0.01

    # agreement voting needs ~cm accuracy, not the full CAD cloud: ADD is
    # a mean over points, so a fixed 500-point subsample (the reference
    # loss's CAD sample size, model.py:416-434) changes the vote decision
    # negligibly and keeps the per-frame host cost flat in cloud size
    _n_vote_points = 500

    def __init__(self, class_id, pcd, is_symmetric, n_votes: int = 3):
        self.class_id = class_id
        pcd = np.asarray(pcd)
        if len(pcd) > self._n_vote_points:
            keep = np.random.RandomState(0).permutation(len(pcd))[
                : self._n_vote_points
            ]
            pcd = pcd[keep]
        self._pcd = pcd
        self._is_symmetric = is_symmetric
        self._n_votes = n_votes
        self._poses = deque([], 6)
        self.is_spawned = False

    @property
    def pose(self) -> Optional[np.ndarray]:
        if not self.is_spawned:
            return None
        return self._poses[-1]

    def append_pose(self, pose: np.ndarray) -> None:
        if not self.is_spawned:
            self._poses.append(np.asarray(pose))

    def validate(self) -> bool:
        if self.is_spawned:
            return True
        if len(self._poses) < self._n_votes:
            return False

        latest = self._poses[-1]
        previous = list(self._poses)[:-1]
        add, add_s = average_distance(
            [self._pcd] * len(previous),
            [latest] * len(previous),
            previous,
        )
        errors = add_s if self._is_symmetric else add
        threshold = (
            self._adds_threshold if self._is_symmetric else self._add_threshold
        )
        if (np.asarray(errors) < threshold).sum() >= (self._n_votes - 1):
            self.is_spawned = True
            self._poses = tuple(self._poses)
        return self.is_spawned


class ObjectMapping:
    """instance_id -> ObjectTrack registry."""

    def __init__(self, models, symmetric_class_ids, n_votes: int = 3):
        self._models = models
        self._symmetric = set(int(c) for c in symmetric_class_ids)
        self._n_votes = n_votes
        self._tracks: Dict[int, ObjectTrack] = {}

    def update(self, instance_id: int, class_id: int, pose: np.ndarray):
        if instance_id not in self._tracks:
            self._tracks[instance_id] = ObjectTrack(
                class_id,
                self._models.get_pcd(class_id),
                class_id in self._symmetric,
                n_votes=self._n_votes,
            )
        track = self._tracks[instance_id]
        track.append_pose(pose)
        track.validate()
        return track

    def remove(self, instance_id: int):
        self._tracks.pop(instance_id, None)

    @property
    def spawned(self) -> Dict[int, ObjectTrack]:
        return {
            k: t for k, t in self._tracks.items() if t.is_spawned
        }

    @property
    def tracks(self) -> Dict[int, ObjectTrack]:
        return dict(self._tracks)
