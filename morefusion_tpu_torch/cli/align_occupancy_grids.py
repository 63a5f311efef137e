"""Occupancy-grid alignment study.

    python -m morefusion_tpu_torch.cli.align_occupancy_grids [--frame 0]
        [--iterations 100] [--seed 0] [--voxel-dim 32] [--device cuda]

Port of ``examples/preliminary/align_occupancy_grids.py``, plus
``--device`` (default ``cuda``). Fuses a synthetic frame into the
multi-instance occupancy map, takes the most visible instance's grids
(occupied, empty, other instances), perturbs its true pose and registers
its CAD points back onto the grids (``contrib/occupancy_registration.py``;
one min-distance launch an iteration). Prints the ADD trajectory at ten
points; ``main`` returns the ADD of every iteration.
"""

from __future__ import annotations

import argparse

import numpy as np


def _perturbed(T, rng, angle=0.15, shift=0.02):
    """``T`` turned by ``angle`` rad about a random axis and shifted by up
    to ``shift`` m (the example's draws, in its order)."""
    from ..geometry.transform import quaternion_matrix_np

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    half = angle / 2.0
    q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
    dT = quaternion_matrix_np(q.astype(np.float32))
    dT[:3, 3] = rng.uniform(-shift, shift, 3)
    return T @ dT


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--voxel-dim", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the registration")
    return parser.parse_args(argv)


def target_problem(args):
    """The fused frame's target: ``(target id, class id, true pose, pitch,
    origin, stacked grids (3, V, V, V), CAD points)``."""
    from ..contrib import MultiInstanceOccupancyMapping
    from ..datasets.rgbd_pose_estimation.synthetic import (
        SyntheticRGBDPoseEstimationDataset,
    )
    from ..geometry import pointcloud_from_depth

    ds = SyntheticRGBDPoseEstimationDataset(seed=args.seed)
    frame = ds.get_frame(args.frame)
    models = ds.models
    K = frame["intrinsic_matrix"]
    pcd = pointcloud_from_depth(frame["depth"], fx=K[0, 0], fy=K[1, 1],
                                cx=K[0, 2], cy=K[1, 2])
    nonnan = ~np.isnan(pcd).any(axis=2)

    mapping = MultiInstanceOccupancyMapping()
    for i, instance_id in enumerate(frame["instance_ids"]):
        class_id = int(frame["class_ids"][i])
        pitch = models.get_voxel_pitch(args.voxel_dim, class_id)
        mapping.initialize(int(instance_id), pitch=pitch)
        mask = frame["instance_label"] == instance_id
        mapping.integrate(int(instance_id), mask, pcd)

    areas = [(frame["instance_label"] == i).sum()
             for i in frame["instance_ids"]]
    ti = int(np.argmax(areas))
    target_id = int(frame["instance_ids"][ti])
    class_id = int(frame["class_ids"][ti])
    T_true = frame["Ts_cad2cam"][ti]
    pitch = models.get_voxel_pitch(args.voxel_dim, class_id)
    mask = (frame["instance_label"] == target_id) & nonnan
    center = np.nanmedian(pcd[mask], axis=0)
    origin = center - pitch * (args.voxel_dim / 2.0 - 0.5)
    grid_target, grid_nontarget, grid_empty = mapping.get_target_grids(
        target_id, dimensions=(args.voxel_dim,) * 3, pitch=pitch,
        origin=origin)
    # [occupied, empty, other-occupied]: overlap with the target's occupied
    # space is rewarded, with free space and other instances' penalised
    grids = np.stack([grid_target, grid_empty, grid_nontarget])
    pcd_cad = models.get_pcd(class_id).astype(np.float32)
    return target_id, class_id, T_true, pitch, origin, grids, pcd_cad


def main(argv=None):
    args = parse_args(argv)
    from ..contrib import OccupancyRegistration
    from ..metrics import average_distance

    rng = np.random.RandomState(args.seed)
    target_id, class_id, T_true, pitch, origin, grids, pcd_cad = (
        target_problem(args))
    T_init = _perturbed(T_true, rng)
    reg = OccupancyRegistration(pcd_cad, grids, pitch=pitch, origin=origin,
                                threshold=2.0, transform_init=T_init,
                                device=args.device)
    print(f"target instance {target_id} (class {class_id})")
    adds = []
    for it, T in enumerate(reg.register_iterative(iteration=args.iterations)):
        add, _ = average_distance([pcd_cad], [T_true], [T])
        adds.append(float(add[0]))
        if it % max(1, args.iterations // 10) == 0 or it == args.iterations:
            print(f"iter {it:>4}: ADD {adds[-1]:.4f}")
    return adds


if __name__ == "__main__":
    main()
