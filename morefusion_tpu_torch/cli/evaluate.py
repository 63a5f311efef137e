"""Evaluate a trained pose model: raw / +ICP / +ICC / +ICC+ICP poses.

    python -m morefusion_tpu_torch.cli.evaluate --log-dir RUN --data VAL \\
        [--methods morefusion morefusion+icp morefusion+icc+icp] [--out F]

Port of ``examples/evaluate.py``, with its flags, its records and its
summary JSON, plus ``--device`` (default ``cuda``). ``--log-dir`` is a run
directory of ``cli/train.py``, or one that holds ``args.json`` and the best
npz archive. The methods:

- ``morefusion``: the batched eval step's best-confidence pose, scored by
  the step's ADD / ADD-S (the tail batch padded to ``--batch-size``);
- ``morefusion+icp``, ``morefusion+icc``, ``morefusion+icc+icp``: one
  batched prediction pass (the same sampling as the eval step), then ICC
  over all crops of a frame together (``--icc-protocol joint``, the
  reference protocol; ``single`` refines each crop alone) and ICP per crop,
  scored on the host with the full CAD cloud (``metrics.average_distance``),
  beside the ``morefusion(host)`` row of the raw poses scored the same way.

ICC runs at ``voxel_dim = 32 * --icc-grid-scale`` on grids upsampled on the
host (``upsample_observed_grid``); ``--icc-coarse-to-fine`` first runs the
whole budget at 32^3.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import _eval

METHODS = ("morefusion", "morefusion+icp", "morefusion+icc",
           "morefusion+icc+icp")
HOST_RAW = "morefusion(host)"
ADD_KEYS = ("add", "add_s", "add_or_add_s")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log-dir", required=True, help="training out dir")
    parser.add_argument("--data", required=True,
                        help="packed or reindexed val set")
    parser.add_argument("--n-examples", type=int, default=None)
    parser.add_argument("--methods", nargs="+",
                        default=["morefusion", "morefusion+icp"],
                        choices=METHODS)
    parser.add_argument("--out", default=None, help="summary and records")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute for the conv / dense stacks")
    parser.add_argument("--grid-variant", default="observed",
                        choices=sorted(_eval.EVAL_CASES),
                        help="occupancy grids at eval: observed maps / full "
                        "nontarget CAD grids / with the background")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="batch of the eval step and the prediction "
                        "pass")
    parser.add_argument("--icc-protocol", default="joint",
                        choices=["joint", "single"],
                        help="joint: refine all objects of a frame together;"
                        " single: each crop alone")
    parser.add_argument("--icc-iterations", type=int, default=30)
    parser.add_argument("--icc-alpha-decay", action="store_true",
                        help="cosine-decay the ICC rate over the iterations")
    parser.add_argument("--icc-no-early-stop", action="store_true",
                        help="no plateau stop")
    parser.add_argument("--icc-cross-mode", default="resample",
                        choices=["resample", "exact"])
    parser.add_argument("--icc-grid-scale", type=int, default=1,
                        help="refine on grids upsampled to (32*s)^3 at "
                        "pitch/s")
    parser.add_argument("--icc-threshold", type=float, default=2.0,
                        help="pseudo-occupancy ramp width in voxels")
    parser.add_argument("--icc-coarse-to-fine", action="store_true",
                        help="the whole budget at 32^3 first, then at "
                        "--icc-grid-scale from its result")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model, ICC and ICP")
    return parser.parse_args(argv)


def _record(records, method, class_id, add, add_s):
    from ..datasets.ycb_video.class_names import class_ids_symmetric

    records[method].append(dict(
        class_id=int(class_id), add=float(add), add_s=float(add_s),
        add_or_add_s=float(add_s if class_id in class_ids_symmetric
                           else add)))


def _fast_pass(args, ds, transform, eval_step, n, records, info):
    from ..training import BatchLoader

    loader = BatchLoader(ds, args.batch_size, transform, shuffle=False,
                         indices=np.arange(n), drop_last=False)
    t0 = time.perf_counter()
    done = 0
    for batch in loader:
        batch, B = _eval.pad_batch(batch, args.batch_size)
        out = {k: v.detach().cpu().numpy()
               for k, v in eval_step(batch).items()}
        for b in range(B):
            _record(records, "morefusion", int(out["class_id"][b]),
                    out["add"][b], out["add_s"][b])
        done += B
        if done % (args.batch_size * 8) == 0:
            rate = done / (time.perf_counter() - t0)
            print(f"  [fast] {done}/{n} ({rate:.1f} ex/s)", flush=True)
    info["fast_s"] = time.perf_counter() - t0


def predict_all(args, ds, transform, model, n):
    """``(n, 4, 4)`` float64 best-confidence poses of the first ``n``
    crops, from one batched pass."""
    from ..training import BatchLoader

    loader = BatchLoader(ds, args.batch_size, transform, shuffle=False,
                         indices=np.arange(n), drop_last=False)
    q_pred = np.zeros((n, 4), np.float32)
    t_pred = np.zeros((n, 3), np.float32)
    done = 0
    for batch in loader:
        batch, B = _eval.pad_batch(batch, args.batch_size)
        q, t = _eval.predict_best(model, batch)
        q_pred[done:done + B] = q[:B]
        t_pred[done:done + B] = t[:B]
        done += B
    return _eval.pose_matrices(q_pred, t_pred)


def icc_problem(exs, models_bank):
    """The ICC arrays of crops ``exs`` (one group): each object's solid
    points and their SDF, and its crop's pitch, origin, target grid and
    no-entry grid."""
    pts_l, sdf_l, pitch_l, origin_l, g_t, g_ne = [], [], [], [], [], []
    for ex in exs:
        vox = models_bank.get_solid_voxel_grid(int(ex["class_id"]))
        pts_l.append(vox.points.astype(np.float32))
        sdf_l.append(vox.inside_distance.astype(np.float32))
        pitch_l.append(float(ex["pitch"]))
        origin_l.append(np.asarray(ex.get("origin", np.zeros(3)),
                                   np.float64))
        g_t.append(np.asarray(ex["grid_target"], np.float32))
        g_ne.append(np.asarray(ex["grid_nontarget_empty"], np.float32))
    return pts_l, sdf_l, pitch_l, origin_l, g_t, g_ne


def run_icc(args, Ts_init, problem, scale, device):
    """One refine of ``problem`` from ``Ts_init`` on grids upsampled by
    ``scale``: ``(transforms, losses, n_iter)``."""
    from ..contrib import IterativeCollisionCheck
    from ..contrib.collision_refine import upsample_observed_grid

    pts_l, sdf_l, pitch_l, origin_l, g_t, g_ne = problem
    icc = IterativeCollisionCheck(
        Ts_init, pts_l, sdf_l, [p / scale for p in pitch_l], origin_l,
        np.stack([upsample_observed_grid(g, scale) for g in g_t]),
        np.stack([upsample_observed_grid(g, scale) for g in g_ne]),
        voxel_dim=32 * scale, threshold=args.icc_threshold,
        max_points=2048, cross_mode=args.icc_cross_mode, device=device)
    return icc.refine(iterations=args.icc_iterations,
                      early_stop=not args.icc_no_early_stop,
                      alpha_decay=args.icc_alpha_decay)


def refine_group(args, Ts0, problem, device):
    """ICC of one group from ``Ts0`` as ``--icc-coarse-to-fine`` and
    ``--icc-grid-scale`` ask: the refined transforms."""
    Ts_init = list(Ts0)
    if args.icc_coarse_to_fine and args.icc_grid_scale > 1:
        Ts_init = list(run_icc(args, Ts_init, problem, 1, device)[0])
    return run_icc(args, Ts_init, problem, args.icc_grid_scale, device)[0]


def _refine_icc(args, exs, Ts0, models_bank, device):
    """ICC of one frame's crops (``--icc-protocol``): their refined poses."""
    groups = ([list(range(len(exs)))] if args.icc_protocol == "joint"
              else [[k] for k in range(len(exs))])
    T_icc = [None] * len(exs)
    for group in groups:
        refined = refine_group(
            args, [Ts0[k] for k in group],
            icc_problem([exs[k] for k in group], models_bank), device)
        for j, k in enumerate(group):
            T_icc[k] = refined[j]
    return T_icc


def _refine_pass(args, ds, transform, model, models_bank, n, slow_methods,
                 records, info):
    from ..contrib import ICPRegistration
    from ..metrics import average_distance

    device = args.device
    frames = _eval.frames_of(ds, n)
    t0 = time.perf_counter()
    T_pred_all = predict_all(args, ds, transform, model, n)
    info["predict_s"] = time.perf_counter() - t0
    want_icc = any("icc" in m for m in slow_methods)
    records.setdefault(HOST_RAW, [])

    def record(method, class_id, T_true, T):
        add, add_s = average_distance([models_bank.get_pcd(class_id)],
                                      [T_true], [T])
        _record(records, method, class_id, add[0], add_s[0])

    t0 = time.perf_counter()
    icc_s = icp_s = 0.0
    for fi, (frame, idxs) in enumerate(frames.items()):
        if fi and fi % 10 == 0:
            rate = fi / (time.perf_counter() - t0)
            print(f"  [refine] frame {fi}/{len(frames)} "
                  f"({rate:.2f} frames/s)", flush=True)
        exs = [transform(ds[i]) for i in idxs]
        T_true_l = [_eval.pose_matrices(ex["quaternion_true"],
                                        ex["translation_true"])
                    for ex in exs]
        T_icc = None
        if want_icc:
            t1 = time.perf_counter()
            T_icc = _refine_icc(args, exs, [T_pred_all[i] for i in idxs],
                                models_bank, device)
            icc_s += time.perf_counter() - t1
        for k, i in enumerate(idxs):
            ex = exs[k]
            cid = int(ex["class_id"])
            record(HOST_RAW, cid, T_true_l[k], T_pred_all[i])
            mask = ~np.isnan(ex["pcd"]).any(axis=2)
            depth_points = ex["pcd"][mask]
            for method in slow_methods:
                T = (T_icc[k] if "icc" in method else T_pred_all[i]).copy()
                if "icp" in method and len(depth_points) > 10:
                    t1 = time.perf_counter()
                    T = ICPRegistration(depth_points,
                                        models_bank.get_pcd(cid), T,
                                        device=device).register()
                    icp_s += time.perf_counter() - t1
                record(method, cid, T_true_l[k], T)
    info.update(refine_s=time.perf_counter() - t0, icc_s=icc_s, icp_s=icp_s,
                n_frames=len(frames))


def summarize(records):
    """Per-method summary (``training.summarize_records``) of the
    records."""
    from ..training import summarize_records

    summary = {}
    for method, recs in records.items():
        class_ids = np.array([r["class_id"] for r in recs])
        adds = {k: np.array([r[k] for r in recs]) for k in ADD_KEYS}
        summary[method] = summarize_records(class_ids, adds)
    return summary


def dump(summary, records, path):
    out = dict(summary)
    out["records"] = {
        m: {"class_id": [int(r["class_id"]) for r in recs],
            **{k: [float(r[k]) for r in recs] for k in ADD_KEYS}}
        for m, recs in records.items()
    }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def main(argv=None):
    """Evaluate; returns ``(summary, records, info)``. ``info`` holds the
    host-clock seconds of the passes (``fast_s``, ``predict_s``,
    ``refine_s`` and, inside it, ``icc_s`` and ``icp_s``) and the frame
    count."""
    args = parse_args(argv)
    from .. import training
    from ..datasets import ProceduralModels, Transform

    device = torch.device(args.device)
    train_args = training.load_args(args.log_dir)
    with_occupancy = _eval.with_occupancy_of(train_args)
    model = _eval.restore(_eval.build_model(train_args, device, args.bf16),
                          args.log_dir)
    models_bank = ProceduralModels()
    ds = _eval.open_val(args.data)
    transform = Transform(train=False, with_occupancy=with_occupancy,
                          eval_case=_eval.EVAL_CASES[args.grid_variant])
    n = len(ds) if args.n_examples is None else min(args.n_examples, len(ds))
    records = {m: [] for m in args.methods}
    info = dict(n_examples=n)
    if "morefusion" in args.methods:
        bank = training.CadPointBank.build(models_bank, _eval.N_FG_CLASS,
                                           device=device)
        eval_step = training.make_eval_step(model, bank)
        _fast_pass(args, ds, transform, eval_step, n, records, info)
    slow_methods = [m for m in args.methods if m != "morefusion"]
    if slow_methods:
        _refine_pass(args, ds, transform, model, models_bank, n,
                     slow_methods, records, info)

    print(f"evaluated {n} examples")
    summary = summarize(records)
    for method, s in summary.items():
        print(f"[{method}] ADD(-S) AUC={s['main/add_or_add_s/auc']:.4f} "
              f"ADD-S AUC={s['main/add_s/auc']:.4f} "
              f"<2cm={s['main/add_or_add_s/<2cm']:.4f}")
    if args.out:
        dump(summary, records, args.out)
    return summary, records, info


if __name__ == "__main__":
    main(sys.argv[1:])
