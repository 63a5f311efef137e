"""The port's datasets, transform and batch loader against ``morefusion_tpu``.

Both packages run the same seeds on the CPU at a small size (two synthetic
frames of 120x160 with 2-3 objects; the crops stay 256x256 with 32^3
grids): every array they make must be equal, bit for bit. The example
factory (its C++ and its NumPy occupancy mapping), ``reindex`` and its
metadata, the reindexed store with the host augmentation, the packed store
and its ``load_batch`` with the mask truncation, ``ConcatDataset``,
``RandomSamplingDataset``, ``Transform`` (train with a seeded RNG, each
eval case, ``Transform.batch``) and the batch order of ``BatchLoader``,
serial and with two forked workers.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from morefusion_tpu import datasets as JD
from morefusion_tpu.training import data as JData
from morefusion_tpu_torch import datasets as TD
from morefusion_tpu_torch.training import data as TData

torch.set_num_threads(2)

SHAPE = (120, 160)
N_FRAMES = 2


def _equal(got, want, what=""):
    """Dicts (or lists of dicts) of arrays and scalars, equal bit for bit
    with equal dtypes."""
    if isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
        return
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{what}{k}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{k}")


def _synthetic(pkg, **kw):
    return pkg.SyntheticRGBDPoseEstimationDataset(
        split="train", n_frames=N_FRAMES, n_objects=(2, 3),
        image_shape=SHAPE, **kw)


@pytest.fixture(scope="module")
def reindexed(tmp_path_factory):
    root = tmp_path_factory.mktemp("reindexed")
    tdir, jdir = str(root / "torch"), str(root / "jax")
    tmeta = TD.reindex(tdir, [_synthetic(TD)], n_workers=1, progress=False)
    jmeta = JD.reindex(jdir, [_synthetic(JD)], n_workers=1, progress=False)
    return tdir, jdir, tmeta, jmeta


@pytest.fixture(scope="module")
def packed(reindexed, tmp_path_factory):
    tdir, jdir = reindexed[:2]
    root = tmp_path_factory.mktemp("packed")
    tp, jp = str(root / "torch"), str(root / "jax")
    tids = TD.pack_reindexed(tdir, tp, progress=False)
    jids = JD.pack_reindexed(jdir, jp, progress=False)
    assert tids == jids
    return tp, jp


def test_get_example_bit_identical_with_numpy_mapping(monkeypatch):
    """Frame 0 with the NumPy occupancy mapping on both sides (the C++
    mapping is held by ``test_reindex_bit_identical``)."""
    monkeypatch.setenv("MFTPU_NO_NATIVE_MAPPING", "1")
    want = _synthetic(JD).get_example(0)
    got = _synthetic(TD, native_mapping=False).get_example(0)
    assert len(want) >= 2
    _equal(got, want)


def test_reindex_bit_identical(reindexed):
    """Every example of both frames (C++ mapping on both sides), through
    ``reindex``'s npz files, and the metadata."""
    tdir, jdir, tmeta, jmeta = reindexed
    assert tmeta == jmeta and len(tmeta) >= 4
    with open(os.path.join(tdir, "meta.json")) as f:
        assert json.load(f) == jmeta
    for id_ in jmeta:
        with np.load(os.path.join(tdir, f"{id_}.npz")) as t, \
                np.load(os.path.join(jdir, f"{id_}.npz")) as j:
            _equal(dict(t), dict(j), id_)


def test_rebuild_meta(reindexed, tmp_path):
    """On copies: ``rebuild_meta`` rewrites meta.json."""
    tdir = shutil.copytree(reindexed[0], tmp_path / "torch")
    jdir = shutil.copytree(reindexed[1], tmp_path / "jax")
    got = TD.rebuild_meta(tdir, drop_last_frame=False)
    want = JD.rebuild_meta(jdir, drop_last_frame=False)
    assert got == want == reindexed[3]
    assert TD.rebuild_meta(tdir) == JD.rebuild_meta(jdir)


@pytest.mark.parametrize("augmentation", [False, True])
def test_reindexed_dataset(reindexed, augmentation):
    tdir, jdir = reindexed[:2]
    kw = dict(split="train", augmentation=augmentation, seed=3)
    t = TD.RGBDPoseEstimationDatasetReIndexed(tdir, **kw)
    j = JD.RGBDPoseEstimationDatasetReIndexed(jdir, **kw)
    assert t.ids == j.ids
    for i in range(len(j)):
        _equal(t[i], j[i], f"{i}:")
    filtered = dict(kw, min_visibility=0.5, class_ids=[t[0]["class_id"]])
    assert (TD.RGBDPoseEstimationDatasetReIndexed(tdir, **filtered).ids
            == JD.RGBDPoseEstimationDatasetReIndexed(jdir, **filtered).ids)


def test_pack_reindexed_bit_identical(packed):
    tp, jp = packed
    names = sorted(os.listdir(jp))
    assert sorted(os.listdir(tp)) == names
    for name in names:
        if name.endswith(".npy"):
            _equal({name: np.load(os.path.join(tp, name))},
                   {name: np.load(os.path.join(jp, name))})
        elif name.endswith(".npz"):
            _equal(dict(np.load(os.path.join(tp, name))),
                   dict(np.load(os.path.join(jp, name))))
        else:
            with open(os.path.join(tp, name)) as a, \
                    open(os.path.join(jp, name)) as b:
                assert json.load(a) == json.load(b)
    assert TD.is_packed(tp) and not TD.is_packed(os.path.dirname(tp))


@pytest.mark.parametrize("augmentation", [False, True])
def test_packed_load_batch(packed, augmentation):
    tp, jp = packed
    kw = dict(split="train", augmentation=augmentation, seed=1)
    t, j = TD.PackedPoseDataset(tp, **kw), JD.PackedPoseDataset(jp, **kw)
    assert len(t) == len(j) and t.example_ids == j.example_ids
    n = len(j)
    for idx in ([0, n - 1, 1], list(range(n)), [2, 2]):
        _equal(t.load_batch(idx), j.load_batch(idx), f"{idx}:")
    _equal(t.get_example(1), j.get_example(1))
    kw = dict(min_visibility=0.5)
    assert (TD.PackedPoseDataset(tp, **kw).example_ids
            == JD.PackedPoseDataset(jp, **kw).example_ids)


def test_packed_transfer_form_raises(packed):
    """Without its arrays the transfer form raises, as JAX's does."""
    assert not TD.has_transfer_arrays(packed[0])
    for pkg, path in ((TD, packed[0]), (JD, packed[1])):
        with pytest.raises(IOError, match="derive_transfer_arrays"):
            pkg.PackedPoseDataset(path, transfer=True)


def test_concat_and_random_sampling(packed, reindexed):
    tp, jp = packed
    t = TD.ConcatDataset(TD.PackedPoseDataset(tp),
                         TD.RandomSamplingDataset(TD.PackedPoseDataset(tp),
                                                  3, seed=4))
    j = JD.ConcatDataset(JD.PackedPoseDataset(jp),
                         JD.RandomSamplingDataset(JD.PackedPoseDataset(jp),
                                                  3, seed=4))
    assert len(t) == len(j)
    idx = np.random.RandomState(0).permutation(len(j))[:6]
    _equal(t.load_batch(idx), j.load_batch(idx))
    for i in (0, len(j) - 1):
        _equal(t[i], j[i])
    # the npz store has no load_batch: the wrapper says so
    r = TD.RandomSamplingDataset(
        TD.RGBDPoseEstimationDatasetReIndexed(reindexed[0]), 2)
    with pytest.raises(AttributeError):
        r.load_batch([0])


def _examples(reindexed):
    tdir, jdir = reindexed[:2]
    return ([TD.RGBDPoseEstimationDatasetReIndexed(tdir)[i]
             for i in range(len(reindexed[3]))],
            [JD.RGBDPoseEstimationDatasetReIndexed(jdir)[i]
             for i in range(len(reindexed[3]))])


@pytest.mark.parametrize("with_occupancy", [True, False])
def test_transform_train_with_seeded_rng(reindexed, with_occupancy):
    texs, jexs = _examples(reindexed)
    t = TD.Transform(train=True, with_occupancy=with_occupancy, seed=5)
    j = JD.Transform(train=True, with_occupancy=with_occupancy, seed=5)
    for _ in range(3):  # successive draws of the same RNG
        _equal([t(e) for e in texs], [j(e) for e in jexs])


@pytest.mark.parametrize("case", TD.transform.TRAIN_CASES)
def test_transform_eval_case(reindexed, case):
    texs, jexs = _examples(reindexed)
    t = TD.Transform(train=False, with_occupancy=True, eval_case=case)
    j = JD.Transform(train=False, with_occupancy=True, eval_case=case)
    _equal([t(e) for e in texs], [j(e) for e in jexs])


@pytest.mark.parametrize("train", [True, False])
def test_transform_batch(packed, train):
    tp, jp = packed
    n = len(JD.PackedPoseDataset(jp))
    tb = TD.PackedPoseDataset(tp).load_batch(range(n))
    jb = JD.PackedPoseDataset(jp).load_batch(range(n))
    t = TD.Transform(train=train, with_occupancy=True, seed=2)
    j = JD.Transform(train=train, with_occupancy=True, seed=2)
    for _ in range(2):
        _equal(t.batch(tb), j.batch(jb))
    _equal(TD.Transform(train, False).batch(tb),
           JD.Transform(train, False).batch(jb))


def test_batch_loader_order_serial(packed):
    """Shuffled epochs of the packed store with the host augmentation and
    the train transform: both draw from seeded RNGs, in the same order."""
    tp, jp = packed

    def loader(pkg, data, root):
        ds = pkg.PackedPoseDataset(root, augmentation=True, seed=2)
        return data.BatchLoader(ds, 2, pkg.Transform(True, True, seed=3),
                                shuffle=True, seed=7)

    t, j = loader(TD, TData, tp), loader(JD, JData, jp)
    assert len(t) == len(j) >= 2
    for _ in range(2):
        _equal(list(t), list(j))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_batch_loader_order_with_workers(packed, num_workers):
    """Two forked workers give the serial order (no RNG in the dataset or
    the eval transform), with ``drop_last`` off: the last batch is short."""
    tp, jp = packed

    def loader(pkg, data, root, workers):
        return data.BatchLoader(pkg.PackedPoseDataset(root), 2,
                                pkg.Transform(False, True), shuffle=True,
                                seed=1, drop_last=False,
                                num_workers=workers)

    t, j = loader(TD, TData, tp, num_workers), loader(JD, JData, jp, 0)
    assert len(t) == len(j)
    for _ in range(2):
        got, want = list(t), list(j)
        _equal(got, want)
    n = len(JD.PackedPoseDataset(jp))
    assert len(want[-1]["class_id"]) == (n % 2 or 2)


def test_batch_loader_npz_store(reindexed):
    """The per-example path (a store without ``load_batch``)."""
    tdir, jdir = reindexed[:2]
    t = TData.BatchLoader(TD.RGBDPoseEstimationDatasetReIndexed(tdir), 2,
                          TD.Transform(True, True, seed=1), seed=3)
    j = JData.BatchLoader(JD.RGBDPoseEstimationDatasetReIndexed(jdir), 2,
                          JD.Transform(True, True, seed=1), seed=3)
    _equal(list(t), list(j))


def test_batch_loader_raises_a_fault_of_load_batch(packed):
    """A store that supports ``load_batch`` takes that path alone: an
    error inside it reaches the caller, not the per-example path."""
    class Faulty(TD.PackedPoseDataset):
        def load_batch(self, indices):
            raise AttributeError("fault inside load_batch")

        def get_example(self, index):
            raise AssertionError("the per-example path ran")

    tp = packed[0]
    for ds in (Faulty(tp), TD.ConcatDataset(Faulty(tp)),
               TD.RandomSamplingDataset(Faulty(tp), 2)):
        assert ds.supports_load_batch
        with pytest.raises(AttributeError, match="fault inside"):
            list(TData.BatchLoader(ds, 2, shuffle=False))
    npz = TD.RGBDPoseEstimationDatasetReIndexed
    assert not getattr(npz, "supports_load_batch", False)
