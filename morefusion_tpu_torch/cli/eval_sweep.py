"""Batched evaluation sweep over runs, grid variants and datasets.

    python -m morefusion_tpu_torch.cli.eval_sweep --runs-root RUNS \\
        --out-dir OUT --sweep occ:observed:VAL occ:nontarget_full:VAL \\
        occ:full_bg:VAL noocc:observed:VAL

Port of ``examples/eval_sweep.py``, plus ``--device`` (default ``cuda``).
Each entry ``run:variant:data`` scores ``RUNS/run`` on ``data`` with the
grid variant's occupancy grids (the occupancy ablation axis) by the batched
eval step, and writes ``OUT/eval_<run>_<variant>[_<base>].json`` (``base``
the data directory's name, left out for ``val_packed``) with the summary
under ``morefusion`` and the per-crop records, which
``cli/ablation_report.py`` reads. One model and one eval step per run and
one dataset per data directory serve all their entries. A run trained
``--tiny`` is built tiny (the JAX script always builds the full width).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import _eval


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs-root", default="runs",
                        help="directory of the run directories")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument(
        "--sweep", nargs="+", required=True,
        help="entries run_name:grid_variant:data_dir; output file is "
        "eval_<run>_<variant>[_<dataset-basename>].json")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the eval step")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the sweep."""
    args = parse_args(argv)
    from .. import training
    from ..datasets import ProceduralModels, Transform

    device = torch.device(args.device)
    bank = training.CadPointBank.build(ProceduralModels(), _eval.N_FG_CLASS,
                                       device=device)
    run_cache, ds_cache = {}, {}
    for entry in args.sweep:
        run_name, variant, data = entry.split(":")
        if run_name not in run_cache:
            log_dir = os.path.join(args.runs_root, run_name)
            train_args = training.load_args(log_dir)
            model = _eval.restore(_eval.build_model(train_args, device),
                                  log_dir)
            run_cache[run_name] = (training.make_eval_step(model, bank),
                                   _eval.with_occupancy_of(train_args))
        eval_step, with_occ = run_cache[run_name]
        if data not in ds_cache:
            ds_cache[data] = _eval.open_val(data)
        transform = Transform(train=False, with_occupancy=with_occ,
                              eval_case=_eval.EVAL_CASES[variant])
        loader = training.BatchLoader(ds_cache[data], args.batch_size,
                                      transform, shuffle=False,
                                      drop_last=False)
        ev = training.Evaluator()
        for batch in loader:
            batch, n_b = _eval.pad_batch(batch, args.batch_size)
            ev.add_batch({k: v.detach().cpu().numpy()[:n_b]
                          for k, v in eval_step(batch).items()})
        summary = ev.summarize()

        tag = f"{run_name}_{variant}"
        base = os.path.basename(os.path.normpath(data))
        if base != "val_packed":
            tag += f"_{base}"
        with open(os.path.join(args.out_dir, f"eval_{tag}.json"), "w") as f:
            json.dump({"morefusion": summary, "records": ev.records()}, f,
                      indent=2)
        print(f"[{tag}] ADD(-S) AUC={summary['main/add_or_add_s/auc']:.4f} "
              f"ADD-S AUC={summary['main/add_s/auc']:.4f} "
              f"<2cm={summary['main/add_or_add_s/<2cm']:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
