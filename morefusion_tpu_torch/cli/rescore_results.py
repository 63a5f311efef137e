"""Re-score external pose results.

    python -m morefusion_tpu_torch.cli.rescore_results --results R.json
        --ground-truth GT.json [--out summary.json]

Port of ``examples/rescore_results.py`` (host only). Loads poses in the
external-results JSON layout (``datasets/external_results.py``), matches
each record to the ground-truth record of the same ``(image_id,
class_id)``, scores ADD / ADD-S / ADD(-S) on the procedural models' points
and prints the class-averaged AUCs. ``main`` returns the summary.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--results", required=True, help="poses JSON")
    parser.add_argument("--ground-truth", required=True, help="GT JSON")
    parser.add_argument("--out", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets import ProceduralModels
    from ..datasets.external_results import load_results_json
    from ..datasets.ycb_video.class_names import class_ids_symmetric
    from ..metrics import average_distance
    from ..training import summarize_records

    models = ProceduralModels()
    results = load_results_json(args.results)
    gt_map = {(g["image_id"], g["class_id"]): g["T_cad2cam"]
              for g in load_results_json(args.ground_truth)}

    class_ids, adds, add_ss, add_or = [], [], [], []
    n_missing = 0
    for r in results:
        key = (r["image_id"], r["class_id"])
        if key not in gt_map:
            n_missing += 1
            continue
        add, add_s = average_distance([models.get_pcd(r["class_id"])],
                                      [gt_map[key]], [r["T_cad2cam"]])
        class_ids.append(r["class_id"])
        adds.append(float(add[0]))
        add_ss.append(float(add_s[0]))
        symmetric = r["class_id"] in class_ids_symmetric
        add_or.append(float(add_s[0] if symmetric else add[0]))

    summary = summarize_records(np.asarray(class_ids), {
        "add": np.asarray(adds), "add_s": np.asarray(add_ss),
        "add_or_add_s": np.asarray(add_or)})
    print(f"{len(class_ids)} records scored ({n_missing} without GT); "
          f"ADD(-S) AUC={summary['main/add_or_add_s/auc']:.4f} "
          f"ADD-S AUC={summary['main/add_s/auc']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
