"""Why ICC helps or not: its objective at predicted, true and refined poses.

    python -m morefusion_tpu_torch.cli.icc_diagnose --log-dir RUN \\
        --data VAL [--n-frames 60] [--perturb-t 0.02 --perturb-r 10] \\
        [--out F]

Port of ``examples/icc_diagnose.py``, plus ``--device`` (default
``cuda``). Over the first ``--n-frames`` frames of the val set, all objects
of a frame refined together (``IterativeCollisionCheck``):

1. the objective landscape: the ICC loss and its per-object penalty and
   reward at the predicted and at the true poses. Where ``loss(true) >=
   loss(pred)``, the objective's minimum is not at the true configuration;
2. the collision signal: the penalty at the predicted poses beside the
   true poses';
3. descent against accuracy: per frame, the loss drop of the refine beside
   the change of the mean ADD(-S).

``--perturb-t`` / ``--perturb-r`` start from the true poses plus noise
instead of the model's poses (the interpenetration regime ICC is built
for). ``--grid-variant nontarget_full`` repeats the analysis on full CAD
nontarget grids. Prints the summary; ``--out`` writes it with the frames'
rows. A run trained ``--tiny`` is built tiny (the JAX script always builds
the full width).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import _eval

PAD_BATCH = 16  # the prediction's batch, as the JAX script pads it


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", required=True)
    parser.add_argument("--data", required=True)
    parser.add_argument("--n-frames", type=int, default=60)
    parser.add_argument("--grid-variant", default="observed",
                        choices=sorted(_eval.EVAL_CASES))
    parser.add_argument("--icc-cross-mode", default="resample",
                        choices=["resample", "exact"])
    parser.add_argument("--iterations", type=int, default=30)
    parser.add_argument("--alpha", type=float, default=0.01)
    parser.add_argument("--alpha-decay", action="store_true",
                        help="cosine-decay the refinement rate to 0 over "
                        "the iterations")
    parser.add_argument("--perturb-t", type=float, default=0.0,
                        help="start from the true poses plus N(0, sigma) "
                        "translation noise (m per axis)")
    parser.add_argument("--perturb-r", type=float, default=0.0,
                        help="rotation noise sigma (degrees, random axis)")
    parser.add_argument("--perturb-seed", type=int, default=7)
    parser.add_argument("--no-early-stop", action="store_true",
                        help="no plateau stop")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and ICC")
    return parser.parse_args(argv)


def _perturbed(T_true, frame, args):
    prng = np.random.RandomState(args.perturb_seed + int(frame, 10))
    out = []
    for Tt in T_true:
        P = np.eye(4)
        axis = prng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.deg2rad(args.perturb_r) * prng.normal()
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        P[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        P[:3, 3] = args.perturb_t * prng.normal(size=3)
        T_p = Tt.copy()
        T_p[:3, :3] = P[:3, :3] @ Tt[:3, :3]
        T_p[:3, 3] = Tt[:3, 3] + P[:3, 3]
        out.append(T_p)
    return out


def summarize(rows, args):
    lp = np.array([r["loss_pred"] for r in rows])
    lg = np.array([r["loss_gt"] for r in rows])
    lr = np.array([r["loss_refined"] for r in rows])
    dadd = np.array([np.mean(r["add_refined"]) - np.mean(r["add_pred"])
                     for r in rows])
    dloss = lr - lp
    pen_p = np.concatenate([r["penalty_pred"] for r in rows])
    pen_g = np.concatenate([r["penalty_gt"] for r in rows])
    return dict(
        grid_variant=args.grid_variant,
        iterations=args.iterations,
        alpha=args.alpha,
        alpha_decay=args.alpha_decay,
        early_stop=not args.no_early_stop,
        perturb_t=args.perturb_t,
        perturb_r=args.perturb_r,
        n_frames=len(rows),
        loss_pred_mean=float(lp.mean()),
        loss_gt_mean=float(lg.mean()),
        loss_refined_mean=float(lr.mean()),
        frac_gt_below_pred=float((lg < lp).mean()),
        frac_refined_below_gt=float((lr < lg).mean()),
        penalty_pred_mean=float(pen_p.mean()),
        penalty_gt_mean=float(pen_g.mean()),
        corr_dloss_dadd=(float(np.corrcoef(dloss, dadd)[0, 1])
                         if len(rows) > 2 else None),
        mean_dadd=float(dadd.mean()),
        add_init_mean=float(np.mean(np.concatenate(
            [r["add_pred"] for r in rows]))),
        add_refined_mean=float(np.mean(np.concatenate(
            [r["add_refined"] for r in rows]))),
    )


def main(argv=None):
    """Run the diagnosis; returns ``(summary, rows)``."""
    args = parse_args(argv)
    from .. import training
    from ..contrib import IterativeCollisionCheck
    from ..datasets import ProceduralModels, Transform
    from ..datasets.ycb_video.class_names import class_ids_symmetric
    from ..metrics import average_distance

    device = torch.device(args.device)
    train_args = training.load_args(args.log_dir)
    with_occupancy = _eval.with_occupancy_of(train_args)
    model = _eval.restore(_eval.build_model(train_args, device),
                          args.log_dir)
    models_bank = ProceduralModels()
    ds = _eval.open_val(args.data)
    transform = Transform(train=False, with_occupancy=with_occupancy,
                          eval_case=_eval.EVAL_CASES[args.grid_variant])
    frame_items = list(_eval.frames_of(ds, len(ds)).items())
    if args.n_frames:
        frame_items = frame_items[: args.n_frames]

    def add_of(cid, T_true, T):
        add, add_s = average_distance([models_bank.get_pcd(cid)], [T_true],
                                      [T])
        return float(add_s[0] if cid in class_ids_symmetric else add[0])

    keys = ["class_id", "rgb", "pcd", "pitch"]
    if with_occupancy:
        keys += ["origin", "grid_nontarget_empty"]
    rows = []
    for fi, (frame, idxs) in enumerate(frame_items):
        exs = [transform(ds[i]) for i in idxs]
        B = len(exs)
        batch = {k: np.stack([np.asarray(ex[k]) for ex in exs])
                 for k in keys}
        batch, _ = _eval.pad_batch(batch, PAD_BATCH)
        q, t = _eval.predict_best(model, batch)
        T_pred = list(_eval.pose_matrices(q[:B], t[:B]))
        T_true = [_eval.pose_matrices(ex["quaternion_true"],
                                      ex["translation_true"]) for ex in exs]
        if args.perturb_t or args.perturb_r:
            T_pred = _perturbed(T_true, frame, args)

        grids = [models_bank.get_solid_voxel_grid(int(ex["class_id"]))
                 for ex in exs]
        icc = IterativeCollisionCheck(
            T_pred,
            [g.points.astype(np.float32) for g in grids],
            [g.inside_distance.astype(np.float32) for g in grids],
            [float(ex["pitch"]) for ex in exs],
            [np.asarray(ex.get("origin", np.zeros(3)), np.float64)
             for ex in exs],
            np.stack([np.asarray(ex["grid_target"], np.float32)
                      for ex in exs]),
            np.stack([np.asarray(ex["grid_nontarget_empty"], np.float32)
                      for ex in exs]),
            max_points=2048, cross_mode=args.icc_cross_mode, device=device)
        loss_pred, pen_pred, rew_pred = icc.loss_components()
        loss_gt, pen_gt, rew_gt = icc.loss_components(T_true)
        refined, _, n_iter = icc.refine(
            iterations=args.iterations, alpha=args.alpha,
            early_stop=not args.no_early_stop, alpha_decay=args.alpha_decay)
        loss_ref, pen_ref, rew_ref = icc.loss_components()

        cids = [int(ex["class_id"]) for ex in exs]
        add_pred = [add_of(c, Tt, Tp) for c, Tt, Tp in
                    zip(cids, T_true, T_pred)]
        add_ref = [add_of(c, Tt, Tr) for c, Tt, Tr in
                   zip(cids, T_true, refined)]
        rows.append(dict(
            frame=frame, n_objects=B, n_iter=int(n_iter),
            loss_pred=loss_pred, loss_gt=loss_gt, loss_refined=loss_ref,
            penalty_pred=[float(x) for x in pen_pred],
            penalty_gt=[float(x) for x in pen_gt],
            penalty_refined=[float(x) for x in pen_ref],
            reward_pred=[float(x) for x in rew_pred],
            reward_gt=[float(x) for x in rew_gt],
            reward_refined=[float(x) for x in rew_ref],
            add_pred=add_pred, add_refined=add_ref))
        if fi % 10 == 0:
            print(f"[{fi}/{len(frame_items)}] {frame}: "
                  f"loss pred={loss_pred:+.4f} gt={loss_gt:+.4f} "
                  f"refined={loss_ref:+.4f}  "
                  f"mean ADD {np.mean(add_pred):.4f}->"
                  f"{np.mean(add_ref):.4f}", flush=True)

    summary = summarize(rows, args)
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, frames=rows), f, indent=2)
    return summary, rows


if __name__ == "__main__":
    main(sys.argv[1:])
