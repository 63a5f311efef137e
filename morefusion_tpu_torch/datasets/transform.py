"""Training transform: dtype casts + occupancy-grid boolean algebra.

Own copy of ``morefusion_tpu/datasets/transform.py``: builds the
``grid_target`` / ``grid_nontarget_empty`` pair the occupancy-aware model
consumes, with the randomized 9-case grid-combination sampling during
training (an occupancy-information dropout that makes the model robust to
partial maps) and the deterministic ``empty+nontarget`` case at eval.
"""

from __future__ import annotations

import numpy as np

TRAIN_CASES = (
    "none",
    "empty",
    "nontarget",
    "empty+nontarget",
    "nontarget_full",
    "empty+nontarget_full",
    "other_full",
    "nontarget_full+other_full",
    "empty+nontarget_full+other_full",
)


class Transform:
    def __init__(
        self,
        train: bool,
        with_occupancy: bool,
        seed: int = 0,
        eval_case: str = "empty+nontarget",
    ):
        """``eval_case`` selects the deterministic grid combination used
        when ``train=False`` — the occupancy-ablation grid variants
        (reference ``docs/index.html:200-203``):

        - ``empty+nontarget``: observed maps (the MF row; default)
        - ``empty+nontarget_full``: full nontarget CAD grids (+target-)
        - ``empty+nontarget_full+other_full``: ~grid_target_full, i.e.
          full grids incl. background (+target-+bg; the reference
          evaluate.py input)
        """
        assert eval_case in TRAIN_CASES
        self._train = train
        self._with_occupancy = with_occupancy
        self._rng = np.random.RandomState(seed)
        self._eval_case = eval_case

    def __call__(self, in_data: dict) -> dict:
        in_data = dict(in_data)
        in_data["class_id"] = np.int32(in_data["class_id"])
        in_data["pcd"] = in_data["pcd"].astype(np.float32)
        in_data["quaternion_true"] = in_data["quaternion_true"].astype(
            np.float32
        )
        in_data["translation_true"] = in_data["translation_true"].astype(
            np.float32
        )

        # pitch/origin stay in both modes (our SingleView3D takes them as
        # explicit inputs instead of recomputing per sample on device).
        in_data["origin"] = in_data["origin"].astype(np.float32)
        in_data["pitch"] = np.float32(in_data["pitch"])

        if not self._with_occupancy:
            for k in (
                "grid_target",
                "grid_nontarget",
                "grid_empty",
                "grid_target_full",
                "grid_nontarget_full",
            ):
                in_data.pop(k, None)
            return in_data

        grid_target = in_data.pop("grid_target") > 0.5
        grid_nontarget = in_data.pop("grid_nontarget") > 0.5
        grid_empty = in_data.pop("grid_empty") > 0.5
        grid_nontarget = grid_nontarget ^ grid_target
        grid_empty = grid_empty ^ grid_target

        grid_target_full = in_data.pop("grid_target_full").astype(bool)

        grid_nontarget_full = in_data.pop("grid_nontarget_full")
        nontarget_ids = np.unique(grid_nontarget_full)
        nontarget_ids = nontarget_ids[nontarget_ids > 0]
        if len(nontarget_ids) > 0:
            # random id-subset dropout is a training augmentation; eval
            # uses every nontarget object's grid
            if self._train and len(nontarget_ids) > 1:
                nontarget_ids = self._rng.choice(
                    nontarget_ids,
                    size=self._rng.randint(1, len(nontarget_ids) + 1),
                    replace=False,
                )
            grid_nontarget_full = np.isin(grid_nontarget_full, nontarget_ids)
        else:
            grid_nontarget_full = np.zeros_like(grid_target)
        grid_nontarget_full = grid_nontarget_full ^ grid_target_full

        case = (
            self._rng.choice(TRAIN_CASES)
            if self._train
            else self._eval_case
        )

        if case == "none":
            grid_nontarget_empty = np.zeros_like(grid_target)
        elif case == "empty+nontarget_full+other_full":
            grid_nontarget_empty = ~grid_target_full
        elif case == "empty":
            grid_nontarget_empty = grid_empty
        elif case == "nontarget":
            grid_nontarget_empty = grid_nontarget
        elif case == "empty+nontarget":
            grid_nontarget_empty = grid_nontarget | grid_empty
        elif case == "nontarget_full":
            grid_nontarget_empty = grid_nontarget_full
        elif case == "empty+nontarget_full":
            grid_nontarget_empty = grid_empty | grid_nontarget_full
        else:
            grid_other_full = (
                ~grid_target_full
                & ~grid_nontarget_full
                & ~grid_empty
                & ~grid_target
                & ~grid_nontarget
            )
            if case == "other_full":
                grid_nontarget_empty = grid_other_full
            else:
                assert case == "nontarget_full+other_full"
                grid_nontarget_empty = grid_nontarget_full | grid_other_full

        in_data["grid_target"] = grid_target
        in_data["grid_nontarget_empty"] = grid_nontarget_empty
        return in_data

    def batch(self, batch: dict) -> dict:
        """Vectorized transform of a pre-stacked batch (packed fast path).

        Same semantics as ``__call__`` applied per example, but the bulk
        casts happen once per batch and the grid algebra runs on stacked
        bool arrays; only the per-example random draws (nontarget-id
        subset, case choice) loop in Python. rgb stays uint8 (a 4x smaller
        copy to the device; the model normalizes from uint8-range).
        """
        out = dict(batch)
        out["class_id"] = np.asarray(batch["class_id"], np.int32)
        for k in ("pcd", "quaternion_true", "translation_true", "origin"):
            if k in batch:  # "pcd" is absent in the transfer form
                out[k] = np.asarray(batch[k], np.float32)
        out["pitch"] = np.asarray(batch["pitch"], np.float32)

        if not self._with_occupancy:
            for k in (
                "grid_target",
                "grid_nontarget",
                "grid_empty",
                "grid_target_full",
                "grid_nontarget_full",
            ):
                out.pop(k, None)
            return out

        gt = np.asarray(out.pop("grid_target")) > 0.5
        gn = (np.asarray(out.pop("grid_nontarget")) > 0.5) ^ gt
        ge = (np.asarray(out.pop("grid_empty")) > 0.5) ^ gt
        gtf = np.asarray(out.pop("grid_target_full")).astype(bool)
        gnf_ids = np.asarray(out.pop("grid_nontarget_full"))

        B = len(gt)
        gne = np.empty_like(gt)
        for b in range(B):
            counts = np.bincount(gnf_ids[b].ravel())
            ids = np.nonzero(counts)[0]
            ids = ids[ids > 0]
            if self._train and len(ids) > 1:
                ids = self._rng.choice(
                    ids, size=self._rng.randint(1, len(ids) + 1),
                    replace=False,
                )
            # id-subset LUT gather instead of np.isin (no sort)
            lut = np.zeros(len(counts), bool)
            lut[ids] = True
            gnf = lut[gnf_ids[b]] ^ gtf[b]

            case = (
                self._rng.choice(TRAIN_CASES)
                if self._train
                else self._eval_case
            )
            if case == "none":
                gne[b] = False
            elif case == "empty+nontarget_full+other_full":
                gne[b] = ~gtf[b]
            elif case == "empty":
                gne[b] = ge[b]
            elif case == "nontarget":
                gne[b] = gn[b]
            elif case == "empty+nontarget":
                gne[b] = gn[b] | ge[b]
            elif case == "nontarget_full":
                gne[b] = gnf
            elif case == "empty+nontarget_full":
                gne[b] = ge[b] | gnf
            else:
                other = ~gtf[b] & ~gnf & ~ge[b] & ~gt[b] & ~gn[b]
                if case == "other_full":
                    gne[b] = other
                else:
                    gne[b] = gnf | other

        out["grid_target"] = gt
        out["grid_nontarget_empty"] = gne
        return out
