"""ICP against ICC on perturbed synthetic scenes.

    python -m morefusion_tpu_torch.cli.check_icp_vs_icc [--n-scenes 3]
        [--n-objects 3]

Port of ``examples/check_icp_vs_icc.py``, plus ``--device`` (default
``cuda``). Each scene of ``PlaneTypeSceneGeneration`` is rendered from
one camera and fused (no tracking); the true poses are
perturbed by ``--angle-deg`` about a random axis and up to ``--trans`` m,
then refined by (a) ICP per object against its observed points, (b) ICC of
all objects together on the fused grids, in the resample and the exact
cross mode, and (c) resample ICC followed by ICP. Prints the mean ADD of
each method; ``main`` returns every object's ADD.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

ICC_MODES = ("resample", "exact")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-scenes", type=int, default=3)
    parser.add_argument("--n-objects", type=int, default=3)
    parser.add_argument("--angle-deg", type=float, default=8.0)
    parser.add_argument("--trans", type=float, default=0.015)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of ICP and ICC")
    return parser.parse_args(argv)


def _scene(args, models, scene_i):
    """One rendered and fused scene: ``(frame, label, world cloud,
    fusion, {instance: class})``."""
    from ..geometry import pointcloud_from_depth, transform_points_np
    from ..runtime.fusion import OccupancyFusion
    from ..simulation import PlaneTypeSceneGeneration

    gen = PlaneTypeSceneGeneration(
        models, n_object=args.n_objects,
        random_state=np.random.RandomState(args.seed + scene_i))
    gen.generate()
    T_cam = gen.random_camera_trajectory(4, 3, distance=(0.5, 0.7))[0]
    frame = gen.render_frame(T_cam, shape=(240, 320))
    K = frame["intrinsic_matrix"]
    depth = frame["depth"]
    label = frame["instance_label"]
    pcd_cam = pointcloud_from_depth(depth, fx=K[0, 0], fy=K[1, 1],
                                    cx=K[0, 2], cy=K[1, 2])
    H, W = depth.shape
    flat = pcd_cam.reshape(-1, 3)
    ok = ~np.isnan(flat).any(axis=1)
    pcd_world = np.full_like(flat, np.nan)
    pcd_world[ok] = transform_points_np(flat[ok], frame["T_cam2world"])
    pcd_world = pcd_world.reshape(H, W, 3)

    fusion = OccupancyFusion(models, size_filter=False)
    inst_to_class = {int(i): int(c) for i, c in
                     zip(frame["instance_ids"], frame["class_ids"])}
    fusion.process_frame(pcd_world, label, inst_to_class, track=False,
                         camera_origin=frame["T_cam2world"][:3, 3])
    return frame, label, pcd_world, fusion, inst_to_class


def main(argv=None):
    """Run the study; returns ``(errors, icc_iters)``: every object's ADD
    (m) per method, in scene and instance order, and each ICC refine's
    iteration count per mode."""
    args = parse_args(argv)
    import scipy.spatial.transform

    from ..contrib import ICPRegistration, IterativeCollisionCheck
    from ..datasets import ProceduralModels
    from ..metrics import average_distance

    device = torch.device(args.device)
    rng = np.random.RandomState(args.seed)
    models = ProceduralModels()
    errors = {"init": [], "icp": [], "icc[resample]": [], "icc[exact]": [],
              "icc+icp": []}
    icc_iters = {mode: [] for mode in ICC_MODES}

    for scene_i in range(args.n_scenes):
        frame, label, pcd_world, fusion, inst_to_class = _scene(
            args, models, scene_i)

        # the true world-frame poses and their perturbed starts
        ids = sorted(inst_to_class)
        T_true, T_init = {}, {}
        for k, ins in enumerate(ids):
            Tt = frame["T_cam2world"] @ frame["Ts_cad2cam"][k]
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            P = np.eye(4)
            P[:3, :3] = scipy.spatial.transform.Rotation.from_rotvec(
                np.radians(args.angle_deg) * axis).as_matrix()
            P[:3, 3] = rng.uniform(-args.trans, args.trans, 3)
            T_true[ins] = Tt
            T_init[ins] = Tt @ P

        def add_of(Ts):
            out = []
            for ins in ids:
                cad = models.get_pcd(inst_to_class[ins])
                a, _ = average_distance([cad], [T_true[ins]], [Ts[ins]])
                out.append(float(a[0]))
            return out

        def observed(ins):
            return pcd_world[(label == ins)
                             & ~np.isnan(pcd_world).any(axis=2)]

        def icp_refine(T_in):
            out = {}
            for ins in ids:
                pts = observed(ins)
                if len(pts) < 10:
                    out[ins] = T_in[ins]
                    continue
                out[ins] = ICPRegistration(
                    pts, models.get_pcd(inst_to_class[ins]), T_in[ins],
                    device=device).register(voxel_size=0.01)
            return out

        errors["init"] += add_of(T_init)
        errors["icp"] += add_of(icp_refine(T_init))

        # ICC on the fused grids, each object's grid centred on its points
        pts_l, sdf_l, pitch_l, origin_l, g_t, g_ne, Ts0 = (
            [], [], [], [], [], [], [])
        for ins in ids:
            vox = models.get_solid_voxel_grid(inst_to_class[ins])
            pts_l.append(vox.points.astype(np.float32))
            sdf_l.append(vox.inside_distance.astype(np.float32))
            pitch = models.get_voxel_pitch(32, inst_to_class[ins])
            origin = np.median(observed(ins), axis=0) - pitch * 15.5
            pitch_l.append(pitch)
            origin_l.append(origin)
            gt, gn, ge = fusion.get_grids(ins, pitch, origin)
            g_t.append(gt)
            g_ne.append(np.maximum(gn, ge))
            Ts0.append(T_init[ins])
        T_icc = None
        for mode in ICC_MODES:
            icc = IterativeCollisionCheck(
                Ts0, pts_l, sdf_l, pitch_l, origin_l, np.stack(g_t),
                np.stack(g_ne), max_points=2048, cross_mode=mode,
                device=device)
            refined, losses, n_iter = icc.refine(iterations=30)
            T_mode = {ins: refined[k] for k, ins in enumerate(ids)}
            errors[f"icc[{mode}]"] += add_of(T_mode)
            icc_iters[mode].append(int(n_iter))
            if mode == "resample":
                T_icc = T_mode
            print(f"scene {scene_i}: icc[{mode}] {int(n_iter)} iters, "
                  f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
        errors["icc+icp"] += add_of(icp_refine(T_icc))

    print("\nmean ADD (m):")
    for k, v in errors.items():
        print(f"  {k:14s} {np.mean(v):.4f}  (n={len(v)})")
    for mode, it in icc_iters.items():
        print(f"  icc[{mode}] mean iterations: {np.mean(it):.1f}")
    return errors, icc_iters


if __name__ == "__main__":
    main(sys.argv[1:])
