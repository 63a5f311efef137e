"""Multi-instance point-cloud ICP study.

    python -m morefusion_tpu_torch.cli.align_pointclouds [--frame 0]
        [--iterations 50] [--seed 0] [--device cuda]

Port of ``examples/preliminary/align_pointclouds.py``, plus ``--device``
(default ``cuda``). Renders a cluttered synthetic frame, starts every
instance with 30 or more observed points at the centroid of its masked
depth points (no rotation), runs gated ICP (``contrib/icp.py``; one
nearest-neighbour launch an iteration) and prints ADD before and after
against the true poses. ``main`` returns ``(ADD init, ADD icp)`` lists.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of ICP")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..contrib import ICPRegistration
    from ..datasets.rgbd_pose_estimation.synthetic import (
        SyntheticRGBDPoseEstimationDataset,
    )
    from ..geometry import pointcloud_from_depth
    from ..metrics import average_distance

    ds = SyntheticRGBDPoseEstimationDataset(seed=args.seed)
    frame = ds.get_frame(args.frame)
    models = ds.models
    K = frame["intrinsic_matrix"]
    pcd = pointcloud_from_depth(frame["depth"], fx=K[0, 0], fy=K[1, 1],
                                cx=K[0, 2], cy=K[1, 2])
    nonnan = ~np.isnan(pcd).any(axis=2)

    print(f"{'instance':>8} {'class':>5} {'ADD init':>10} {'ADD icp':>10}")
    adds_init, adds_icp = [], []
    for i, instance_id in enumerate(frame["instance_ids"]):
        class_id = int(frame["class_ids"][i])
        T_true = frame["Ts_cad2cam"][i]
        mask = (frame["instance_label"] == instance_id) & nonnan
        if mask.sum() < 30:
            continue
        pcd_depth = pcd[mask].astype(np.float32)
        pcd_cad = models.get_pcd(class_id).astype(np.float32)
        T_init = np.eye(4)
        T_init[:3, 3] = pcd_depth.mean(axis=0)
        icp = ICPRegistration(pcd_depth, pcd_cad, transform_init=T_init,
                              device=args.device)
        T_icp = icp.register(iteration=args.iterations)
        add_i, _ = average_distance([pcd_cad], [T_true], [T_init])
        add_f, _ = average_distance([pcd_cad], [T_true], [T_icp])
        adds_init.append(float(add_i[0]))
        adds_icp.append(float(add_f[0]))
        print(f"{instance_id:>8} {class_id:>5} "
              f"{adds_init[-1]:>10.4f} {adds_icp[-1]:>10.4f}")
    print(f"mean ADD: init {np.mean(adds_init):.4f} -> "
          f"icp {np.mean(adds_icp):.4f} over {len(adds_icp)} instances")
    return adds_init, adds_icp


if __name__ == "__main__":
    main()
