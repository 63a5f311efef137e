"""Training-resolution A/B table of two runs' validation curves.

    python -m morefusion_tpu_torch.cli.resolution_ab --a RUN_A --b RUN_B
        --out JSON [--a-name r5tex_240x320] [--b-name r5hires_480x640]

Port of ``examples/resolution_ab.py``: pairs the ``log.json`` validation
AUCs of two runs that differ only in their sources' render resolution
(240x320 and 480x640, the reference's,
``morefusion/datasets/ycb_video/dataset.py:83-104``) at matched epochs
(snapped to the 0.5-epoch grid: a resumed run's evaluations shift by a
fraction of an epoch), and writes the matched-epoch series, each run's
best row and the mean matched delta as JSON. Host only. ``main`` returns
the record.
"""

from __future__ import annotations

import argparse
import json
import os

KEY = "main/add_or_add_s/auc"  # the in-loop validation rows


def val_series(run_dir):
    with open(os.path.join(run_dir, "log.json")) as f:
        rows = json.load(f)
    out = {}
    for r in rows:
        if KEY in r:
            out[round(2.0 * float(r["epoch"])) / 2.0] = float(r[KEY])
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", required=True, help="240x320-source run dir")
    p.add_argument("--b", required=True, help="480x640-source run dir")
    p.add_argument("--a-name", default="r5tex_240x320")
    p.add_argument("--b-name", default="r5hires_480x640")
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    a, b = val_series(args.a), val_series(args.b)
    shared = sorted(set(a) & set(b))
    table = [
        dict(epoch=e, **{args.a_name: a[e], args.b_name: b[e],
                         "delta": b[e] - a[e]})
        for e in shared
    ]
    best_a = max(a.items(), key=lambda kv: kv[1])
    best_b = max(b.items(), key=lambda kv: kv[1])
    rec = {
        "metric": KEY,
        "matched_epochs": table,
        "best": {
            args.a_name: dict(epoch=best_a[0], auc=best_a[1]),
            args.b_name: dict(epoch=best_b[0], auc=best_b[1]),
            "delta": best_b[1] - best_a[1],
        },
        "mean_delta_matched": (
            sum(r["delta"] for r in table) / len(table) if table else None
        ),
    }
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec["best"], indent=1))
    print(f"matched epochs: {len(table)}, "
          f"mean delta {rec['mean_delta_matched']:+.4f}")
    return rec


if __name__ == "__main__":
    main()
