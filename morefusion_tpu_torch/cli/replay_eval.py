"""Serving quality on a replayed sequence.

    python -m morefusion_tpu_torch.cli.replay_eval --log-dir RUN
        [--sequence DIR] [--n-frames 24] [--n-objects 5]
        [--image-shape 240 320] [--seed 11] [--segmenter SEG_RUN]
        [--with-icp] [--n-votes 3] [--bf16] [--out f.json] [--device cuda]

Port of ``examples/replay_eval.py``, plus ``--device`` (default ``cuda``).
Records a cluttered procedural sequence with true poses (unless
``--sequence`` already holds one), drives the whole ``ScenePipeline``
(fusion, the pose model, n-vote object mapping, async ICC) over it, and
scores each frame's ADD (ADD-S for symmetric classes) of

- ``raw``: the pose model's per-frame poses,
- ``voted``: the object-mapping track's pose,
- ``refined``: the voted pose after the joint collision refinement,
- ``refined_icp`` (``--with-icp``): ICP on the frame's observed depth on top.

The model of ``--log-dir`` is loaded as ``cli/_eval.py`` loads it; the
segmenter of ``--segmenter`` is a ``cli/train_segmentation.py`` run
directory (``args.json`` and its latest checkpoint). Prints the means (all
frames, and the second half once tracks have spawned) and writes them with
every row to ``--out``. ``main`` returns ``(summary, rows, seconds)``: the
seconds of the replay loop, the sequence and the model already loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

KEYS = ("add_raw", "add_voted", "add_refined", "add_refined_icp")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", required=True, help="training out dir")
    parser.add_argument("--sequence", default=None,
                        help="recorded sequence dir (generated if absent)")
    parser.add_argument("--n-frames", type=int, default=24)
    parser.add_argument("--n-objects", type=int, default=5)
    parser.add_argument("--image-shape", type=int, nargs=2,
                        default=(240, 320))
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--segmenter", default=None,
                        help="UNet run dir: predicted masks instead of GT "
                        "labels")
    parser.add_argument("--with-icp", action="store_true",
                        help="per-object ICP on the refined poses")
    parser.add_argument("--n-votes", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models, ICC and ICP")
    return parser.parse_args(argv)


def record_sequence(out_dir, n_frames, n_objects, seed, image_shape):
    """Record ``n_frames`` views of one ``PlaneTypeSceneGeneration`` scene
    along a random camera trajectory, 0.1 s apart."""
    from ..datasets import ProceduralModels
    from ..runtime import SequenceRecorder
    from ..simulation import PlaneTypeSceneGeneration

    gen = PlaneTypeSceneGeneration(
        ProceduralModels(), n_object=n_objects,
        random_state=np.random.RandomState(seed))
    gen.generate()
    # interpolate() yields n_points camera poses in all, not per segment
    traj = gen.random_camera_trajectory(
        n_keypoints=6, n_points=max(2, n_frames))[:n_frames]
    rec = SequenceRecorder(out_dir)
    for k, T_cam in enumerate(traj):
        frame = gen.render_frame(T_cam, shape=tuple(image_shape))
        rec.record(frame["rgb"], frame["depth"], frame["intrinsic_matrix"],
                   frame["T_cam2world"],
                   instance_label=frame["instance_label"],
                   instance_ids=frame["instance_ids"],
                   class_ids=frame["class_ids"],
                   Ts_cad2cam=frame["Ts_cad2cam"], stamp=float(k) / 10.0)
    return out_dir


def load_segmenter(run_dir, device):
    """The ``cli/train_segmentation.py`` run's UNet in a
    ``SegmentationNode``."""
    from .. import training
    from ..models.segmentation import SegmentationNode, UNetSegmentation

    seg_args = training.load_args(run_dir)
    model = UNetSegmentation(
        n_class=22, widths=tuple(seg_args.get("widths", (32, 64, 128, 256))),
        with_boundary=not seg_args.get("no_boundary", False),
        use_depth=seg_args.get("use_depth", False)).to(device)
    ckpt = training.CheckpointManager(run_dir)
    if ckpt.restore_latest(training.create_train_state(model)) is None:
        raise SystemExit(f"no checkpoint in {run_dir}")
    return SegmentationNode(model, device=device)


def _icp_row(frame, gid, T_ref, class_id, models_bank, device):
    """ICP in the camera frame on the observed points of ground-truth
    instance ``gid``; the refined world pose, or None under 11 points."""
    from ..contrib import ICPRegistration
    from ..geometry import pointcloud_from_depth

    K = frame["intrinsic_matrix"]
    pcd = pointcloud_from_depth(frame["depth"], fx=K[0, 0], fy=K[1, 1],
                                cx=K[0, 2], cy=K[1, 2])
    # the ground truth's mask: predicted masks carry other ids
    ok = (frame["instance_label"] == gid) & ~np.isnan(pcd).any(axis=2)
    pts = pcd[ok]
    if len(pts) <= 10:
        return None
    T_cam = np.linalg.inv(frame["T_cam2world"]) @ T_ref
    reg = ICPRegistration(pts, models_bank.get_pcd(class_id), T_cam,
                          device=device)
    return frame["T_cam2world"] @ reg.register()


def summarize(rows, n_frames):
    """The mean and count of each ADD key, over all rows and over the
    second half of the sequence."""
    def mean_of(key, rows_):
        vals = [r[key] for r in rows_ if key in r]
        return (float(np.mean(vals)), len(vals)) if vals else (None, 0)

    summary = {}
    for key in KEYS:
        m, n = mean_of(key, rows)
        if n:
            summary[key] = dict(mean=m, n=n)
    half = [r for r in rows if r["frame"] >= n_frames // 2]
    for key in KEYS:
        m, n = mean_of(key, half)
        if n:
            summary[f"{key}_2nd_half"] = dict(mean=m, n=n)
    summary["n_frames"] = n_frames
    summary["n_rows"] = len(rows)
    return summary


def main(argv=None):
    args = parse_args(argv)
    from .. import runtime
    from ..datasets import ProceduralModels
    from ..datasets.ycb_video.class_names import class_ids_symmetric
    from ..metrics import average_distance
    from ..runtime import load_sequence
    from ..training import load_args
    from ._eval import build_model, restore

    device = torch.device(args.device)
    model = restore(build_model(load_args(args.log_dir), device,
                                bf16=args.bf16), args.log_dir)
    model.eval()
    models_bank = ProceduralModels()
    segmenter = (load_segmenter(args.segmenter, device) if args.segmenter
                 else None)

    seq_dir = args.sequence or os.path.join(args.log_dir, "replay_seq")
    if not os.path.exists(os.path.join(seq_dir, "sequence.json")):
        print(f"recording {args.n_frames}-frame sequence -> {seq_dir}")
        record_sequence(seq_dir, args.n_frames, args.n_objects, args.seed,
                        args.image_shape)

    pipe = runtime.ScenePipeline(
        model, models_bank, segmenter=segmenter, native_mapping=True,
        size_filter=False, n_votes=args.n_votes, async_refine=True,
        device=device)
    pipe.warmup()

    sym_set = set(class_ids_symmetric)

    def add_for(class_id, T_est, T_gt):
        cad = models_bank.get_pcd(class_id)[:500]
        adds, add_ss = average_distance([cad], [T_gt], [T_est])
        return float(add_ss[0] if class_id in sym_set else adds[0])

    rows = []
    frames = list(load_sequence(seq_dir))
    t0 = time.perf_counter()
    for fi, frame in enumerate(frames):
        gt_world = {
            int(iid): (frame["T_cam2world"] @ frame["Ts_cad2cam"][k],
                       int(frame["class_ids"][k]))
            for k, iid in enumerate(frame["instance_ids"])}
        kwargs = {}
        if segmenter is None:
            kwargs["instance_label"] = frame["instance_label"]
            kwargs["instance_to_class"] = {
                int(i): int(c)
                for i, c in zip(frame["instance_ids"], frame["class_ids"])}
        poses = pipe.process_frame(
            frame["rgb"].astype(np.float32), frame["depth"],
            frame["intrinsic_matrix"], frame["T_cam2world"], refine=True,
            **kwargs)
        refined_map = pipe.last_refined

        def match_gt(class_id, T_est):
            """The nearest same-class true object within 0.30 m."""
            best, best_d = None, 0.30
            for gid, (T_gt, gcls) in gt_world.items():
                if gcls != class_id:
                    continue
                d = float(np.linalg.norm(T_est[:3, 3] - T_gt[:3, 3]))
                if d < best_d:
                    best, best_d = gid, d
            return best

        for ins_id, res in poses.items():
            T_raw = res["T_cad2world"]
            gid = match_gt(res["class_id"], T_raw)
            if gid is None:
                continue
            T_gt = gt_world[gid][0]
            row = dict(frame=fi, instance=int(ins_id), gt=int(gid),
                       class_id=res["class_id"],
                       add_raw=add_for(res["class_id"], T_raw, T_gt))
            track = pipe.object_mapping.spawned.get(ins_id)
            if track is not None:
                row["add_voted"] = add_for(res["class_id"], track.pose, T_gt)
            T_ref = res.get("T_cad2world_refined")
            if T_ref is None:
                T_ref = refined_map.get(ins_id)
            if T_ref is not None:
                row["add_refined"] = add_for(res["class_id"], T_ref, T_gt)
                if args.with_icp:
                    T_icp = _icp_row(frame, gid, T_ref, res["class_id"],
                                     models_bank, device)
                    if T_icp is not None:
                        row["add_refined_icp"] = add_for(
                            res["class_id"], T_icp, T_gt)
            rows.append(row)
    pipe.flush_refine()
    seconds = time.perf_counter() - t0

    summary = summarize(rows, len(frames))
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=1)
        print("wrote", args.out)
    return summary, rows, seconds


if __name__ == "__main__":
    main()
