"""Training-curve comparison: eval metrics against epoch for two runs.

    python -m morefusion_tpu_torch.cli.plot_curves [--runs DIR]
        [--occ-run occ] [--noocc-run noocc] [--out PNG]

Port of ``examples/plot_curves.py`` (reference role: chainer's LogReport
curves via ``log.json``): ADD(-S) AUC and <2cm against epoch for the
occupancy (MF) and no-occupancy (MF-occ) runs, as a PNG drawn by
matplotlib's Agg backend (imported inside ``main``), then a markdown
table of each epoch's best AUC. Host only. ``main`` returns the table's
lines.
"""

from __future__ import annotations

import argparse
import json
import os

# the palette of the JAX script (a validated adjacent pair, light mode)
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
SERIES = {"occ": "#2a78d6", "noocc": "#eb6834"}
LABELS = {"occ": "MF (occupancy input)", "noocc": "MF-occ (no occupancy)"}

METRICS = (
    ("main/add_or_add_s/auc", "ADD(-S) AUC"),
    ("main/add_or_add_s/<2cm", "ADD(-S) <2cm"),
)


def eval_points(log_path, key):
    """[(epoch, value)] of the evaluation rows (those that carry ``key``)."""
    with open(log_path) as f:
        log = json.load(f)
    return [
        (e["epoch"], e[key])
        for e in log
        if key in e and "epoch" in e
    ]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", default="runs")
    parser.add_argument("--occ-run", default="occ")
    parser.add_argument("--noocc-run", default="noocc")
    parser.add_argument("--out", default="docs/results/r3_curves.png")
    return parser.parse_args(argv)


def _draw(runs, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(
        1, len(METRICS), figsize=(5.2 * len(METRICS), 3.6),
        facecolor=SURFACE,
    )
    for ax, (key, title) in zip(axes, METRICS):
        ax.set_facecolor(SURFACE)
        ends = []
        for name, log_path in runs.items():
            pts = eval_points(log_path, key)
            if not pts:
                continue
            xs, ys = zip(*pts)
            ax.plot(
                xs, ys, color=SERIES[name], lw=2,
                label=LABELS[name], solid_capstyle="round",
            )
            ends.append((name, xs[-1], ys[-1]))
        # direct end labels, nudged apart where they collide
        if ends:
            lo_lim, hi_lim = ax.get_ylim()
            span = (hi_lim - lo_lim) or 1.0
            order = sorted(range(len(ends)), key=lambda i: ends[i][2])
            offs = [0.0] * len(ends)
            for rank in range(1, len(order)):
                lo, hi = order[rank - 1], order[rank]
                gap = (ends[hi][2] + offs[hi]) - (ends[lo][2] + offs[lo])
                min_gap = 0.06 * span
                if gap < min_gap:
                    offs[hi] += min_gap - gap
            for (name, x, y), off in zip(ends, offs):
                ax.annotate(
                    f" {y:.3f}", (x, y + off), color=SERIES[name],
                    fontsize=8, va="center",
                )
        ax.set_title(title, color=TEXT, fontsize=11)
        ax.set_xlabel("epoch", color=TEXT_2, fontsize=9)
        ax.tick_params(colors=TEXT_2, labelsize=8)
        ax.grid(True, color="#e8e7e3", lw=0.75)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color("#d8d7d2")
        ax.legend(
            frameon=False, fontsize=8, labelcolor=TEXT_2, loc="lower right"
        )
    fig.tight_layout()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def main(argv=None):
    args = parse_args(argv)
    runs = {
        "occ": os.path.join(args.runs, args.occ_run, "log.json"),
        "noocc": os.path.join(args.runs, args.noocc_run, "log.json"),
    }
    runs = {k: v for k, v in runs.items() if os.path.exists(v)}
    if not runs:
        raise SystemExit(f"no log.json found under {args.runs}")
    _draw(runs, args.out)
    print("wrote", args.out)

    # each epoch's best AUC, one row an epoch
    key = METRICS[0][0]
    lines = ["\n| epoch | " + " | ".join(LABELS[n] for n in runs) + " |",
             "|---|" + "---|" * len(runs)]
    cols = {n: dict(eval_points(runs[n], key)) for n in runs}
    epochs = sorted({round(e) for c in cols.values() for e in c})
    for ep in epochs:
        row = [f"| {ep} "]
        for n in runs:
            near = [v for e, v in cols[n].items() if round(e) == ep]
            row.append(f"| {max(near):.4f} " if near else "| ")
        lines.append("".join(row) + "|")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
