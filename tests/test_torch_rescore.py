"""The external-results loaders, ``cli.rescore_results`` and
``cli.stratify_results`` against the JAX package and its scripts.

On files the tests write (the repository holds no PoseCNN results and no
committed val set): a results JSON, PoseCNN ``.mat`` files written with
``scipy.io.savemat``, an evaluation dump in ``cli.evaluate``'s ``records``
layout and a packed set's ``scalars.npz``. All of it is host NumPy in both
packages: records, summaries and reports must be equal (summaries within
1e-12, as float64 sums in either order).
"""

import json
import os
import runpy
import sys
from unittest import mock

import numpy as np
import pytest
import scipy.io
import scipy.spatial.transform
import torch

from morefusion_tpu.datasets import external_results as JE
from morefusion_tpu.utils import provenance as JP
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch import utils as TU
from morefusion_tpu_torch.cli import rescore_results as cli_rescore
from morefusion_tpu_torch.cli import stratify_results as cli_stratify
from morefusion_tpu_torch.datasets import external_results as TE

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
ATOL = 1e-12


def _pose(rng, angle=0.6):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
    T = np.eye(4)
    T[:3, :3] = scipy.spatial.transform.Rotation.from_quat(
        [q[1], q[2], q[3], q[0]]).as_matrix()
    T[:3, 3] = rng.uniform(-0.2, 0.2, 3) + [0, 0, 0.7]
    return T


def _records(seed, n=24, image_ids=4):
    rng = np.random.RandomState(seed)
    return [dict(image_id=f"{k % image_ids:04d}", class_id=int(k % 21) + 1,
                 T_cad2cam=_pose(rng)) for k in range(n)]


def _write_json(path, records, nested=False):
    rows = [dict(image_id=r["image_id"], class_id=r["class_id"],
                 T_cad2cam=(r["T_cad2cam"].tolist() if nested
                            else r["T_cad2cam"].ravel().tolist()))
            for r in records]
    with open(path, "w") as f:
        json.dump(rows, f)
    return path


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["image_id"] == w["image_id"]
        assert g["class_id"] == w["class_id"]
        assert g["T_cad2cam"].dtype == w["T_cad2cam"].dtype
        np.testing.assert_array_equal(g["T_cad2cam"], w["T_cad2cam"])


@pytest.mark.parametrize("nested", [False, True])
def test_load_results_json_matches_jax(tmp_path, nested):
    rows = _records(0)
    rows[3]["image_id"] = None
    path = _write_json(str(tmp_path / "r.json"), rows, nested=nested)
    with open(path) as f:
        data = json.load(f)
    del data[5]["image_id"]  # a record without an image id reads None
    with open(path, "w") as f:
        json.dump(data, f)
    _same_records(TE.load_results_json(path), JE.load_results_json(path))
    assert TD.load_results_json is TE.load_results_json


def _write_mat(path, n, seed):
    rng = np.random.RandomState(seed)
    rois = np.zeros((n, 7))
    rois[:, 1] = rng.randint(-1, 22, n)  # class ids; <= 0 are skipped
    poses = np.zeros((n, 7))
    poses[:, :4] = rng.normal(size=(n, 4))
    poses[:, 4:] = rng.uniform(-0.2, 0.8, (n, 3))
    scipy.io.savemat(path, dict(rois=rois, poses=poses))
    return path


@pytest.mark.parametrize("n", [1, 9])
def test_load_posecnn_mat_matches_jax(tmp_path, n):
    path = _write_mat(str(tmp_path / "000123.mat"), n, seed=n)
    want = JE.load_posecnn_mat(path)
    _same_records(TE.load_posecnn_mat(path), want)
    assert all(r["image_id"] == "000123" for r in want)
    assert TD.load_posecnn_mat is TE.load_posecnn_mat


def test_posecnn_results_dataset(tmp_path, monkeypatch):
    root = tmp_path / "ycb_video" / "YCB_Video_toolbox" / \
        "results_PoseCNN_RSS2018"
    root.mkdir(parents=True)
    for k in (2, 0, 1):
        _write_mat(str(root / f"{k:06d}.mat"), 5, seed=k)
    monkeypatch.setenv("MOREFUSION_TPU_DATA", str(tmp_path))
    assert TU.get_data_path("a", "b") == JP.get_data_path("a", "b") == \
        os.path.join(str(tmp_path), "a", "b")
    got, want = TE.YCBVideoPoseCNNResultsDataset(), \
        JE.YCBVideoPoseCNNResultsDataset()
    assert got.ids == want.ids == ["000000", "000001", "000002"]
    assert got.split == "keyframe"
    for i in range(3):
        _same_records(got[i], want[i])
    with pytest.raises(IOError):
        TE.YCBVideoPoseCNNResultsDataset(str(tmp_path / "missing"))


def test_githash_matches_jax():
    assert TU.githash() == JP.githash()
    assert TU.githash("/") == JP.githash("/") == ""


def _same_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, float):
        assert abs(got - want) <= ATOL
    else:
        assert got == want


def run_example(name, argv):
    with mock.patch.object(sys, "argv", [name + ".py"] + list(argv)):
        runpy.run_path(os.path.join(EXAMPLES, name + ".py"),
                       run_name="__main__")


def test_rescore_results_matches_example(tmp_path, capsys):
    """Perturbed poses against their ground truth, two results without a
    ground-truth record."""
    gts = _records(1)
    rng = np.random.RandomState(2)
    results = []
    for g in gts:
        T = g["T_cad2cam"].copy()
        T[:3, 3] += rng.normal(0, 0.01, 3)
        T[:3, :3] = _pose(rng, angle=rng.uniform(0, 0.2))[:3, :3] @ T[:3, :3]
        results.append(dict(g, T_cad2cam=T))
    results[5]["image_id"] = "9999"
    results[7]["class_id"] = 22
    res = _write_json(str(tmp_path / "results.json"), results)
    gt = _write_json(str(tmp_path / "gt.json"), gts)
    argv = ["--results", res, "--ground-truth", gt]
    run_example("rescore_results", argv + ["--out", str(tmp_path / "j.json")])
    want_out = capsys.readouterr().out
    summary = cli_rescore.main(argv + ["--out", str(tmp_path / "t.json")])
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert "22 records scored (2 without GT)" in got_out
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        got = json.load(f)
    _same_tree(got, want)
    _same_tree(json.loads(json.dumps(summary)), want)


def _evaluation_dump(path, class_ids, seed):
    """An evaluation dump in ``cli.evaluate``'s layout."""
    rng = np.random.RandomState(seed)
    n = len(class_ids)
    records = {}
    for m in ("morefusion", "morefusion+icp", "morefusion+icc"):
        add = rng.gamma(2.0, 0.01, n)
        add_s = add * rng.uniform(0.3, 1.0, n)
        records[m] = dict(class_id=[int(c) for c in class_ids],
                          add=add.tolist(), add_s=add_s.tolist(),
                          add_or_add_s=add.tolist())
    with open(path, "w") as f:
        json.dump({"morefusion": {"main/auc": 0.5}, "records": records}, f)
    return path


@pytest.mark.parametrize("methods", [None, ["morefusion+icc"]])
def test_stratify_results_matches_example(tmp_path, capsys, methods):
    rng = np.random.RandomState(3)
    n = 60
    class_ids = rng.randint(1, 22, n).astype(np.int32)
    val = tmp_path / "val_packed"
    val.mkdir()
    vis = rng.uniform(0.2, 1.0, n).astype(np.float32)
    vis[:3] = [0.5, 0.9, 1.0]  # on the bins' edges
    np.savez(str(val / "scalars.npz"), visibility=vis, class_id=class_ids)
    art = _evaluation_dump(str(tmp_path / "eval.json"), class_ids, 4)
    argv = ["--artifact", art, "--val-packed", str(val)]
    if methods:
        argv += ["--methods"] + methods
    run_example("stratify_results",
                argv + ["--out", str(tmp_path / "j.json")])
    want_out = capsys.readouterr().out
    report = cli_stratify.main(argv + ["--out", str(tmp_path / "t.json")])
    got_out = capsys.readouterr().out
    assert got_out == want_out
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        got = json.load(f)
    _same_tree(got, want)
    _same_tree(json.loads(json.dumps(report)), want)
    assert len(want["methods"]) == (len(methods) if methods else 2)


def test_stratify_results_rejects_another_order(tmp_path):
    class_ids = np.arange(1, 11, dtype=np.int32)
    val = tmp_path / "val"
    val.mkdir()
    np.savez(str(val / "scalars.npz"), visibility=np.ones(10, np.float32),
             class_id=class_ids[::-1])
    art = _evaluation_dump(str(tmp_path / "eval.json"), class_ids, 5)
    with pytest.raises(ValueError):
        cli_stratify.main(["--artifact", art, "--val-packed", str(val)])
