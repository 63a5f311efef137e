"""Occupancy-ablation report: the reference's core claim, on our data.

    python -m morefusion_tpu_torch.cli.ablation_report --runs OUT

Port of ``examples/ablation_report.py``, on the JSON files of
``cli/eval_sweep.py`` (or ``cli/evaluate.py``). The reference's scoreboard
says the occupancy-aware model beats the occupancy-free one, and gains as
its occupancy grids get more complete. The 4-row table:

- MF-occ: the model trained without the occupancy branch;
- MF: the occupancy model on observed (mapped, noisy) grids;
- MF+target-: the occupancy model on full nontarget CAD grids;
- MF+target-+bg: the occupancy model on full grids with the background;

then the easy-val rows where their files exist, and a paired bootstrap
over the shared val crops (every variant scores the same crops in the same
order, so one index draw applies to all: the spread of a difference leaves
out the crops' own sampling noise).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def rows_for(occ_run: str, noocc_run: str):
    return (
        ("MF-occ (no occupancy)", f"eval_{noocc_run}_observed.json",
         "morefusion"),
        ("MF (observed grids)", f"eval_{occ_run}_observed.json",
         "morefusion"),
        ("MF+target- (full nontarget)",
         f"eval_{occ_run}_nontarget_full.json", "morefusion"),
        ("MF+target-+bg (full grids)", f"eval_{occ_run}_full_bg.json",
         "morefusion"),
    )


_METRICS = (
    ("ADD(-S) AUC", "main/add_or_add_s/auc"),
    ("ADD-S AUC", "main/add_s/auc"),
    ("ADD(-S) <2cm", "main/add_or_add_s/<2cm"),
)


def _bootstrap(row_records, n_boot: int = 1000, seed: int = 0):
    """Paired bootstrap over the shared val crops:
    ``{row_name: {metric_key: (n_boot,) array}}``."""
    from ..training import summarize_records

    names = list(row_records.keys())
    cls0 = np.asarray(row_records[names[0]]["class_id"])
    for name in names[1:]:
        if not np.array_equal(np.asarray(row_records[name]["class_id"]),
                              cls0):
            raise ValueError(
                "records are not aligned across variants; cannot pair")
    adds = {
        name: {k: np.asarray(row_records[name][k])
               for k in ("add", "add_s", "add_or_add_s")}
        for name in names
    }
    n = len(cls0)
    rng = np.random.RandomState(seed)
    out = {name: {key: np.empty(n_boot) for _, key in _METRICS}
           for name in names}
    for b in range(n_boot):
        idx = rng.randint(0, n, n)
        cls_b = cls0[idx]
        for name in names:
            s = summarize_records(cls_b,
                                  {k: v[idx] for k, v in adds[name].items()})
            for _, key in _METRICS:
                out[name][key][b] = s[key]
    return out


def _row(name, s):
    print(f"| {name} | {s['main/add_or_add_s/auc']:.4f} "
          f"| {s['main/add_s/auc']:.4f} "
          f"| {s['main/add_or_add_s/<2cm']:.4f} |")


def print_boot(records, title, n_boot):
    boot = _bootstrap(records, n_boot=n_boot)
    names = list(boot.keys())
    base = names[0]  # the MF-occ row
    print()
    print(f"{title} (n={n_boot}, 95% CI; "
          f"delta rows are vs `{base}` on identical crops):")
    print("| Variant | " + " | ".join(m for m, _ in _METRICS) + " |")
    print("|---|" + "---|" * len(_METRICS))
    for name in names:
        cells = []
        for _, key in _METRICS:
            lo, hi = np.percentile(boot[name][key], [2.5, 97.5])
            cells.append(f"[{lo:.4f}, {hi:.4f}]")
        print(f"| {name} | " + " | ".join(cells) + " |")
    for name in names[1:]:
        cells = []
        for _, key in _METRICS:
            d = boot[name][key] - boot[base][key]
            lo, hi = np.percentile(d, [2.5, 97.5])
            sig = "*" if lo > 0 or hi < 0 else " "
            cells.append(f"{np.mean(d):+.4f} [{lo:+.4f}, {hi:+.4f}]{sig}")
        print(f"| delta {name} | " + " | ".join(cells) + " |")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", required=True, help="dir with eval jsons")
    parser.add_argument("--occ-run", default="occ",
                        help="run name of the occupancy model")
    parser.add_argument("--noocc-run", default="noocc",
                        help="run name of the no-occupancy model")
    parser.add_argument("--n-boot", type=int, default=1000,
                        help="bootstrap draws (0 = point estimates only)")
    parser.add_argument("--easy-suffix", default="easyval_packed",
                        help="dataset-basename suffix of the easy-val "
                        "sweep files (see eval_sweep.py naming)")
    return parser.parse_args(argv)


def main(argv=None):
    """Print the tables; returns ``{row_name: summary}`` of the main
    table's rows found."""
    args = parse_args(argv)
    print("| Variant | ADD(-S) AUC | ADD-S AUC | ADD(-S) <2cm |")
    print("|---|---|---|---|")
    row_records, found = {}, {}
    for name, fname, method in rows_for(args.occ_run, args.noocc_run):
        path = os.path.join(args.runs, fname)
        if not os.path.exists(path):
            print(f"| {name} | (missing: {fname}) | | |")
            continue
        with open(path) as f:
            blob = json.load(f)
        s = blob[method]
        recs = blob.get("records")
        if recs is not None and method in recs:  # evaluate.py layout
            recs = recs[method]
        if recs:
            row_records[name] = recs
        found[name] = s
        _row(name, s)

    # easy-val continuity rows (3-6 objects a scene)
    easy = [
        ("MF-occ (easy val)",
         f"eval_{args.noocc_run}_observed_{args.easy_suffix}.json"),
        ("MF (easy val)",
         f"eval_{args.occ_run}_observed_{args.easy_suffix}.json"),
    ]
    easy = [(n, f) for n, f in easy
            if os.path.exists(os.path.join(args.runs, f))]
    easy_records = {}
    if easy:
        print()
        print("| Easy val (3-6 obj) | ADD(-S) AUC | ADD-S AUC "
              "| ADD(-S) <2cm |")
        print("|---|---|---|---|")
        for name, fname in easy:
            with open(os.path.join(args.runs, fname)) as f:
                blob = json.load(f)
            if blob.get("records"):
                easy_records[name] = blob["records"]
            _row(name, blob["morefusion"])

    if args.n_boot and len(row_records) >= 2:
        print_boot(row_records, "Paired bootstrap", args.n_boot)
    if args.n_boot and len(easy_records) >= 2:
        print_boot(easy_records, "Paired bootstrap, easy val", args.n_boot)
    return found


if __name__ == "__main__":
    main(sys.argv[1:])
