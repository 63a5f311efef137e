"""Visibility-stratified accuracy of an evaluation's records.

    python -m morefusion_tpu_torch.cli.stratify_results --artifact F.json
        --val-packed VAL [--methods morefusion morefusion+icp] [--out R.json]

Port of ``examples/stratify_results.py`` (host only). Re-scores the
per-crop records of an evaluation dump (``cli/evaluate.py --out``: a
``records`` entry per method with ``class_id``, ``add`` and ``add_s`` in
the val set's order) against the packed val set's per-crop
``visibility`` (its ``scalars.npz``), in the bins [0, 0.5), [0.5, 0.7),
[0.7, 0.9) and [0.9, 1]. Within a bin the AUC is pooled (micro); the
macro AUC over classes of the whole set is the cross-check against the
dump's own table. ``main`` returns the report.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..utils.provenance import get_data_path

BINS = [(0.0, 0.5), (0.5, 0.7), (0.7, 0.9), (0.9, 1.01)]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--artifact",
                        default="docs/results/r4_refine_table_joint.json")
    parser.add_argument("--val-packed", default=get_data_path("val_packed"),
                        help="packed val set (default: under the data "
                        "root, utils.get_data_path)")
    parser.add_argument("--methods", nargs="+",
                        default=["morefusion", "morefusion+icp"])
    parser.add_argument("--out", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets.ycb_video.class_names import class_ids_symmetric
    from ..metrics import ycb_video_add_auc
    from ..training import summarize_records

    z = np.load(os.path.join(args.val_packed, "scalars.npz"))
    vis = z["visibility"]
    cid_packed = z["class_id"]
    with open(args.artifact) as f:
        blob = json.load(f)

    report = {"artifact": args.artifact, "bins": {}, "methods": {}}
    for method in args.methods:
        rec = blob["records"][method]
        cids = np.asarray(rec["class_id"])
        if not (cids == cid_packed).all():
            raise ValueError(
                "record order does not match the packed val index")
        add = np.asarray(rec["add"])
        add_s = np.asarray(rec["add_s"])
        aos = np.where(np.isin(cids, list(class_ids_symmetric)), add_s, add)
        macro = summarize_records(
            cids, {"add_or_add_s": aos})["main/add_or_add_s/auc"]
        rows = {}
        print(f"\n== {method}  (full-set macro AUC {macro:.4f}, "
              f"pooled {ycb_video_add_auc(aos):.4f})")
        for lo, hi in BINS:
            m = (vis >= lo) & (vis < hi)
            if not m.sum():
                continue
            r = rows[f"[{lo:.1f},{hi:.1f})"] = dict(
                n=int(m.sum()),
                pooled_auc=float(ycb_video_add_auc(aos[m])),
                pooled_add_s_auc=float(ycb_video_add_auc(add_s[m])),
                lt_2cm=float((aos[m] < 0.02).mean()),
            )
            print(f"  vis [{lo:.1f},{hi:.1f}): n={r['n']:3d}  "
                  f"ADD(-S) {r['pooled_auc']:.4f}  "
                  f"ADD-S {r['pooled_add_s_auc']:.4f}  "
                  f"<2cm {r['lt_2cm']:.3f}")
        report["methods"][method] = dict(
            macro_auc=float(macro), pooled_auc=float(ycb_video_add_auc(aos)),
            strata=rows)
    report["visibility_frac_below_05"] = float((vis < 0.5).mean())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
