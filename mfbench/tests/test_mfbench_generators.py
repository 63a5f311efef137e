"""Every input is determined by the seed, and every seed makes the same
sizes."""

import numpy as np
import pytest
import torch

from mfbench import generators

SEED = 2**32 + 17  # the driver's seeds exceed 32 bits


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_batch_is_the_seeds():
    a = generators.train_batch(SEED, 3, 2, 16, 8, 0.35, 0.05, 0.3)
    _same(a, generators.train_batch(SEED, 3, 2, 16, 8, 0.35, 0.05, 0.3))
    b = generators.train_batch(SEED + 1, 3, 2, 16, 8, 0.35, 0.05, 0.3)
    assert {k: v.shape for k, v in a.items()} == {
        k: v.shape for k, v in b.items()}
    assert not np.array_equal(a["rgb"], b["rgb"])
    assert 0.25 < np.isnan(a["z"]).mean() < 0.45


def test_weights_and_bank_are_the_seeds():
    cpu = torch.device("cpu")
    named = [("a.weight", (4, 3, 3)), ("a.bias", (4,))]
    w1 = generators.weights(named, SEED, cpu)
    _same({k: v.numpy() for k, v in w1.items()},
          {k: v.numpy() for k, v in generators.weights(named, SEED,
                                                         cpu).items()})
    assert float(w1["a.weight"].abs().max()) <= (3.0 / 9) ** 0.5
    assert float(w1["a.bias"].abs().max()) <= 0.01
    b1 = generators.cad_bank(SEED, [13, 16], cpu, 64)
    b2 = generators.cad_bank(SEED, [13, 16], cpu, 64)
    _same({k: v.numpy() for k, v in b1.items()},
          {k: v.numpy() for k, v in b2.items()})
    assert b1["symmetric"].nonzero().flatten().tolist() == [13, 16]
    inside = b1["solid_sdf"][b1["solid_mask"]]
    assert float(inside.min()) >= 0.0


@pytest.mark.parametrize("seed", [SEED, 7])
def test_scene_frame_is_the_seeds(seed):
    bank = {k: v.numpy() for k, v in generators.cad_bank(
        seed, [13], torch.device("cpu"), 64).items()}
    f1 = generators.scene_frame(seed, 1, bank, 96, 128, 6, 16, 0.02)
    f2 = generators.scene_frame(seed, 1, bank, 96, 128, 6, 16, 0.02)
    _same({k: v for k, v in f1.items() if k != "instance_to_class"},
          {k: v for k, v in f2.items() if k != "instance_to_class"})
    assert f1["instance_to_class"] == f2["instance_to_class"]
    n = len(f1["instance_to_class"])
    assert n == 6
    assert len(set(f1["instance_to_class"].values())) == n
    assert f1["target"].shape == (n, 16, 16, 16)
    for k in range(1, n + 1):
        assert (f1["label"] == k).any()


def test_every_seed_gets_the_same_object_counts():
    a = generators.object_counts(SEED, 16, 5, 8)
    b = generators.object_counts(SEED + 1, 16, 5, 8)
    assert sorted(a) == sorted(b) == sorted([5, 6, 7, 8] * 4)
    assert a == generators.object_counts(SEED, 16, 5, 8)
