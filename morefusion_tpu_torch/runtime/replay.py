"""Sequence record and replay.

Port of ``morefusion_tpu/runtime/replay.py`` (host only, NumPy):

- ``SequenceRecorder`` appends sensor frames (with the camera pose and
  optional labels and poses) to an indexed npz directory with time stamps,
  the role of ``rosbag record``;
- ``play_sequence`` streams a recorded directory through a pipeline in
  order, optionally at the recorded timing scaled by a rate, the role of
  ``rosbag play --rate``.

The frame files are ``FrameDirectoryDataset``'s, so a recorded sequence is
also a dataset source, and the layout (``<id>.npz`` and ``sequence.json``)
is the JAX package's: a sequence recorded by either is played by the other.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np

from ..datasets.rgbd_pose_estimation.frame_directory import save_frame


class SequenceRecorder:
    def __init__(self, out_dir: str):
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._stamps = []
        self._count = 0

    def record(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        K: np.ndarray,
        T_cam2world: np.ndarray,
        instance_label: Optional[np.ndarray] = None,
        instance_ids=None,
        class_ids=None,
        Ts_cad2cam=None,
        stamp: Optional[float] = None,
    ) -> str:
        """Append one frame (its time stamp the wall clock unless given);
        returns its id."""
        frame_id = f"{self._count:08d}"
        frame = dict(rgb=np.asarray(rgb), depth=np.asarray(depth),
                     intrinsic_matrix=np.asarray(K),
                     T_cam2world=np.asarray(T_cam2world))
        for key, value in (("instance_label", instance_label),
                           ("instance_ids", instance_ids),
                           ("class_ids", class_ids),
                           ("Ts_cad2cam", Ts_cad2cam)):
            if value is not None:
                frame[key] = np.asarray(value)
        save_frame(os.path.join(self._out_dir, frame_id + ".npz"), frame)
        self._stamps.append(
            dict(id=frame_id, stamp=time.time() if stamp is None else stamp))
        self._count += 1
        with open(os.path.join(self._out_dir, "sequence.json"), "w") as f:
            json.dump({"frames": self._stamps}, f, indent=2)
        return frame_id


def load_sequence(root_dir: str) -> Iterator[dict]:
    """Yield the recorded frames in order, each with its ``id`` and
    ``stamp`` (None for a plain frame directory without ``sequence.json``,
    whose frames come in the order of their file names)."""
    index_file = os.path.join(root_dir, "sequence.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            entries = json.load(f)["frames"]
    else:
        entries = [dict(id=f[:-4], stamp=None)
                   for f in sorted(os.listdir(root_dir))
                   if f.endswith(".npz")]
    for e in entries:
        frame = dict(np.load(os.path.join(root_dir, e["id"] + ".npz")))
        frame["id"] = e["id"]
        frame["stamp"] = e["stamp"]
        yield frame


def play_sequence(
    root_dir: str,
    pipeline,
    rate: float = 0.0,
    use_labels: bool = True,
) -> Dict[str, dict]:
    """Drive ``pipeline.process_frame`` with a recorded sequence; returns
    ``{frame id: its results}``.

    ``rate`` 0 plays as fast as possible; otherwise the recorded gaps
    between stamps, divided by ``rate``, are kept (1.0 is real time).
    ``use_labels`` passes the recorded instance labels (and the instance
    classes, where recorded) to the pipeline; without it the pipeline's
    segmenter labels the frames.
    """
    results = {}
    prev_stamp = prev_wall = None
    for frame in load_sequence(root_dir):
        if rate > 0 and prev_stamp is not None and frame["stamp"]:
            sleep = ((frame["stamp"] - prev_stamp) / rate
                     - (time.time() - prev_wall))
            if sleep > 0:
                time.sleep(sleep)
        prev_stamp = frame.get("stamp")
        prev_wall = time.time()

        kwargs = {}
        if use_labels and "instance_label" in frame:
            kwargs["instance_label"] = frame["instance_label"]
            if "instance_ids" in frame and "class_ids" in frame:
                kwargs["instance_to_class"] = {
                    int(i): int(c)
                    for i, c in zip(frame["instance_ids"], frame["class_ids"])
                }
        results[frame["id"]] = pipeline.process_frame(
            frame["rgb"], frame["depth"], frame["intrinsic_matrix"],
            frame["T_cam2world"], **kwargs)
    return results
