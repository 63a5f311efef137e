"""Shape-ambiguity floor: how much of the AUC gap is missing texture?

    python -m morefusion_tpu_torch.cli.ambiguity_floor
        [--artifact docs/results/r4_refine_table_joint.json]
        [--n-rotations 4000] [--n-points 512] [--angle-min 30] [--out JSON]

Port of ``examples/ambiguity_floor.py``. For a texture-free object, any
estimator can recover its orientation only up to the shape's
near-symmetries: confusing poses that differ by such a rotation ``R``
costs ADD ~= selfADD(R). Per class of the procedural bank, the
**ambiguity floor**

    amb(c) = min over rotations R with angle(R) >= angle_min of
             mean_i || R q_i - q_i ||        (q = centered CAD points)

over a random SO(3) sweep and the three 180-degree axis flips, beside the
per-class ADD of the committed refinement artifact's ``morefusion``
records, and the correlation of the two. Host only (NumPy). ``main``
returns ``dict(summary=..., classes=...)``, as ``--out`` writes it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _rand_rotations(n, rng):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.empty((n, 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    angle = 2 * np.arccos(np.clip(np.abs(w), -1, 1))
    return R, angle


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--artifact", default="docs/results/r4_refine_table_joint.json"
    )
    parser.add_argument("--n-rotations", type=int, default=4000)
    parser.add_argument("--n-points", type=int, default=512)
    parser.add_argument(
        "--angle-min", type=float, default=30.0,
        help="degrees; rotations closer to identity than this do not "
        "count as a distinct (confusable) pose",
    )
    parser.add_argument("--out", default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..datasets import ProceduralModels
    from ..datasets.ycb_video.class_names import (
        class_ids_symmetric,
        class_names,
    )

    rng = np.random.RandomState(0)
    bank = ProceduralModels()

    Rs, angles = _rand_rotations(args.n_rotations, rng)
    # near-symmetries worth probing exactly: 180-degree flips about the
    # principal axes (box and cylinder flips)
    flips = []
    for ax in np.eye(3):
        K = np.array(
            [
                [0, -ax[2], ax[1]],
                [ax[2], 0, -ax[0]],
                [-ax[1], ax[0], 0],
            ]
        )
        flips.append(np.eye(3) + 2 * K @ K)  # Rodrigues at 180 degrees
    Rs = np.concatenate([Rs, np.stack(flips)])
    angles = np.concatenate([angles, np.full(3, np.pi)])
    keep = angles >= np.deg2rad(args.angle_min)
    Rs = Rs[keep]

    with open(args.artifact) as f:
        rec = json.load(f)["records"]["morefusion"]
    cids = np.asarray(rec["class_id"])
    add = np.asarray(rec["add"])

    rows = {}
    for cid in sorted(set(int(c) for c in cids)):
        pcd = np.asarray(bank.get_pcd(cid), dtype=np.float64)
        if len(pcd) > args.n_points:
            pcd = pcd[
                rng.choice(len(pcd), args.n_points, replace=False)
            ]
        q = pcd - pcd.mean(0)
        # the rotation sweep in chunks, to bound memory
        best = np.inf
        for s in range(0, len(Rs), 512):
            Rc = Rs[s : s + 512]
            moved = np.einsum("rij,pj->rpi", Rc, q)
            d = np.linalg.norm(moved - q[None], axis=-1).mean(1)
            best = min(best, float(d.min()))
        sel = cids == cid
        rows[cid] = dict(
            name=class_names[cid],
            ambiguity_floor=best,
            measured_mean_add=float(add[sel].mean()),
            measured_median_add=float(np.median(add[sel])),
            n_crops=int(sel.sum()),
            symmetric_class=bool(cid in class_ids_symmetric),
        )
        r = rows[cid]
        print(
            f"{cid:2d} {r['name']:28s} floor {best * 100:5.1f} cm  "
            f"median ADD {r['measured_median_add'] * 100:5.1f} cm  "
            f"(n={r['n_crops']})"
        )

    floors = np.array([r["ambiguity_floor"] for r in rows.values()])
    med = np.array([r["measured_median_add"] for r in rows.values()])
    corr = float(np.corrcoef(floors, med)[0, 1])
    # a texture-blind estimator that picks the wrong confusable branch
    # half the time pays amb/2 on average, on top of its precision
    summary = dict(
        corr_floor_vs_median_add=corr,
        mean_floor=float(floors.mean()),
        mean_half_floor=float(floors.mean() / 2),
        n_classes=len(rows),
        angle_min_deg=args.angle_min,
    )
    print(f"\ncorr(floor, median ADD) = {corr:.3f}")
    print(
        f"mean ambiguity floor {floors.mean() * 100:.1f} cm "
        f"(half-floor {floors.mean() * 50:.1f} cm)"
    )
    result = dict(summary=summary, classes=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
