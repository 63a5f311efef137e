"""Sequence record and replay, the frame-directory dataset,
``cli.replay_eval`` and ``cli.align_pointclouds`` against the JAX package.

On the CPU at a small size (120x160 frames of 2 objects):
- sequences recorded by either package load in the other, frame for frame
  and bit for bit; ``play_sequence`` passes the pipeline what JAX's does;
- ``FrameDirectoryDataset``'s frames and instance examples equal JAX's, bit
  for bit (NumPy mapping on both sides);
- ``cli.replay_eval`` beside ``examples/replay_eval.py`` on a 4-frame
  sequence with a tiny model in a run directory that both read, held as
  ``tests/test_torch_evaluate.py`` holds ``cli.evaluate``: the same point
  sampling, exact nearest-point searches on the JAX side, ICC at 64 points
  an object. The pipelines' ICC runs 5 iterations in both (its 30 are
  held within JAX's own spread by ``test_torch_pipeline.py``). Rows match
  in frame, instance, object and class; raw and voted ADD within 1e-5 m
  (the pipeline's pose tolerance), refined and refined+ICP ADD within
  2e-4 m (the refiner's 1e-4 pose tolerance carried into ADD);
- ``cli.align_pointclouds`` beside its example: the same instances and
  start ADDs, ICP's ADD within 2e-4 m.
"""

import json
import os
import runpy
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import morefusion_tpu.models as jmodels
from morefusion_tpu import runtime as JR
from morefusion_tpu.contrib import icp as jicp
from morefusion_tpu.datasets import ProceduralModels as JModels
from morefusion_tpu.datasets.rgbd_pose_estimation import (
    frame_directory as JFD,
)
from morefusion_tpu.runtime import pipeline as JPm
from morefusion_tpu_torch import runtime as TR
from morefusion_tpu_torch.cli import align_pointclouds as cli_align
from morefusion_tpu_torch.cli import replay_eval as cli
from morefusion_tpu_torch.datasets import ProceduralModels as TModels
from morefusion_tpu_torch.datasets.rgbd_pose_estimation import (
    frame_directory as TFD,
)
from morefusion_tpu_torch.runtime import pipeline as TPm
from morefusion_tpu_torch.runtime import replay as TRp
from tests.test_torch_datasets import _equal
from tests.test_torch_evaluate import same_inputs, write_run
from tests.test_torch_icp import _exact_pairwise

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SHAPE = (120, 160)
N_FRAMES = 4
RAW_ATOL = 1e-5
REFINED_ATOL = 2e-4
ICC_ITERATIONS = 5


def _jax_record_sequence():
    """``record_sequence`` of ``examples/replay_eval.py``."""
    ns = runpy.run_path(os.path.join(EXAMPLES, "replay_eval.py"),
                        run_name="replay_eval")
    return ns["record_sequence"]


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    root = tmp_path_factory.mktemp("sequences")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    _jax_record_sequence()(jdir, N_FRAMES, 2, 11, SHAPE)
    cli.record_sequence(tdir, N_FRAMES, 2, 11, SHAPE)
    return jdir, tdir


def _frames(load, root):
    return [{k: v for k, v in f.items() if k not in ("id", "stamp")}
            for f in load(root)], [(f["id"], f["stamp"]) for f in load(root)]


def test_recorded_sequences_are_identical(sequences):
    """Both recorders write the same frames and index; each package reads
    the other's sequence as its own."""
    jdir, tdir = sequences
    with open(os.path.join(jdir, "sequence.json")) as f:
        j_index = json.load(f)
    with open(os.path.join(tdir, "sequence.json")) as f:
        t_index = json.load(f)
    assert t_index == j_index
    assert [e["stamp"] for e in t_index["frames"]] == [0.0, 0.1, 0.2, 0.3]
    want, want_ids = _frames(JR.load_sequence, jdir)
    assert len(want) == N_FRAMES
    for load in (JR.load_sequence, TR.load_sequence):
        for root in (jdir, tdir):
            got, ids = _frames(load, root)
            assert ids == want_ids
            _equal(got, want)


def test_load_sequence_without_index(sequences, tmp_path):
    """A plain frame directory: frames in file-name order, no stamps."""
    plain = str(tmp_path / "plain")
    shutil.copytree(sequences[1], plain)
    os.remove(os.path.join(plain, "sequence.json"))
    got, ids = _frames(TR.load_sequence, plain)
    want, want_ids = _frames(JR.load_sequence, plain)
    assert ids == want_ids == [(f"{k:08d}", None) for k in range(N_FRAMES)]
    _equal(got, want)


class _Recorder:
    """A pipeline that records what ``process_frame`` was given."""

    def __init__(self):
        self.calls = []

    def process_frame(self, rgb, depth, K, T_cam2world, **kw):
        self.calls.append(dict(rgb=rgb, depth=depth, K=K,
                               T_cam2world=T_cam2world, **kw))
        return len(self.calls)


@pytest.mark.parametrize("use_labels", [True, False])
def test_play_sequence_passes_what_jax_passes(sequences, use_labels):
    want, got = _Recorder(), _Recorder()
    j_out = JR.play_sequence(sequences[0], want, use_labels=use_labels)
    t_out = TR.play_sequence(sequences[0], got, use_labels=use_labels)
    assert t_out == j_out == {f"{k:08d}": k + 1 for k in range(N_FRAMES)}
    assert len(got.calls) == len(want.calls) == N_FRAMES
    for g, w in zip(got.calls, want.calls):
        assert sorted(g) == sorted(w)
        assert ("instance_label" in g) == use_labels
        for k in w:
            if k == "instance_to_class":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_play_sequence_keeps_the_recorded_rate(sequences, monkeypatch):
    """At ``rate=2`` the 0.1 s gaps become sleeps of at most 0.05 s (less
    the time each frame took); at 0 nothing sleeps."""
    sleeps = []
    monkeypatch.setattr(TRp.time, "sleep", sleeps.append)
    TR.play_sequence(sequences[1], _Recorder(), rate=2.0)
    assert len(sleeps) == N_FRAMES - 1
    assert all(0 < s <= 0.05 for s in sleeps)
    sleeps.clear()
    TR.play_sequence(sequences[1], _Recorder(), rate=0.0)
    assert sleeps == []


def test_frame_directory_dataset_matches_jax(sequences, monkeypatch):
    """Frames and per-instance examples of a recorded sequence, with the
    NumPy occupancy mapping on both sides."""
    monkeypatch.setenv("MFTPU_NO_NATIVE_MAPPING", "1")
    jds = JFD.FrameDirectoryDataset(sequences[0], JModels())
    tds = TFD.FrameDirectoryDataset(sequences[1], TModels(),
                                    native_mapping=False)
    assert len(tds) == len(jds) == N_FRAMES
    assert tds.ids == jds.ids
    _equal(tds.get_frame(1), jds.get_frame(1))
    want = jds.get_example(1)
    assert len(want) >= 1
    _equal(tds.get_example(1), want)
    with pytest.raises(IOError):
        TFD.FrameDirectoryDataset(sequences[1] + "_missing", TModels())


def test_save_frame_keeps_only_frame_keys(tmp_path):
    frame = dict(rgb=np.zeros((2, 3, 3), np.uint8),
                 depth=np.ones((2, 3), np.float32), extra=np.arange(3))
    TFD.save_frame(str(tmp_path / "a" / "f.npz"), frame)
    got = dict(np.load(str(tmp_path / "a" / "f.npz")))
    assert sorted(got) == ["depth", "rgb"]


# ------------------------------------------------------------ replay_eval


def _tiny_jax_singleview3d():
    """``models.SingleView3D`` for JAX's script: the tiny model of the run
    directory (the script builds the full one whatever the run says)."""
    full = jmodels.SingleView3D

    def build(n_fg_class, **kw):
        with mock.patch.object(jmodels, "SingleView3D", full):
            return jmodels.tiny_singleview3d(n_fg_class, **kw)

    return build


def _shorter_icc(module):
    """The pipeline's ICC at ``ICC_ITERATIONS`` (on top of the 64 points an
    object of ``same_inputs``)."""
    base = module.IterativeCollisionCheck

    class Shorter(base):
        def __init__(self, *args, **kw):
            kw["max_points"] = 64
            super().__init__(*args, **kw)

        def refine_async(self, iterations=30, **kw):
            super().refine_async(iterations=ICC_ITERATIONS, **kw)

        def refine(self, iterations=30, **kw):
            return super().refine(iterations=ICC_ITERATIONS, **kw)

    return Shorter


@pytest.fixture(scope="module")
def replayed(sequences, tmp_path_factory):
    """The example and the CLI on JAX's recorded sequence: ``(JAX's dump,
    the port's dump, the port's return)``."""
    root = tmp_path_factory.mktemp("replay")
    run = write_run(str(root / "run"))
    argv = ["--log-dir", run, "--sequence", sequences[0], "--n-votes", "1",
            "--with-icp"]
    j_out, t_out = str(root / "jax.json"), str(root / "torch.json")
    with same_inputs(), \
            mock.patch.object(jmodels, "SingleView3D",
                              _tiny_jax_singleview3d()), \
            mock.patch.object(JPm, "IterativeCollisionCheck",
                              _shorter_icc(JPm)), \
            mock.patch.object(TPm, "IterativeCollisionCheck",
                              _shorter_icc(TPm)), \
            mock.patch.object(JR.ScenePipeline, "warmup",
                              lambda self, *a, **k: None), \
            mock.patch.object(TR.ScenePipeline, "warmup",
                              lambda self, *a, **k: None):
        with mock.patch.object(sys, "argv", ["replay_eval.py"] + argv
                               + ["--out", j_out]):
            runpy.run_path(os.path.join(EXAMPLES, "replay_eval.py"),
                           run_name="__main__")
        ret = cli.main(argv + ["--out", t_out, "--device", "cpu"])
    with open(j_out) as f:
        want = json.load(f)
    with open(t_out) as f:
        got = json.load(f)
    return want, got, ret


TOLERANCES = dict(add_raw=RAW_ATOL, add_voted=RAW_ATOL,
                  add_refined=REFINED_ATOL, add_refined_icp=REFINED_ATOL)


def test_replay_eval_rows_match_example(replayed):
    want, got, _ = replayed
    assert len(got["rows"]) == len(want["rows"]) > 0
    for g, w in zip(got["rows"], want["rows"]):
        assert sorted(g) == sorted(w)
        for k in ("frame", "instance", "gt", "class_id"):
            assert g[k] == w[k], k
        for k, atol in TOLERANCES.items():
            if k in w:
                assert abs(g[k] - w[k]) <= atol, (k, g[k], w[k])
    # every kind of row occurs on this sequence
    for k in TOLERANCES:
        assert any(k in r for r in want["rows"]), k


def test_replay_eval_summary_matches_example(replayed):
    want, got, (summary, rows, seconds) = replayed
    assert got["summary"] == summary and got["rows"] == rows
    assert seconds > 0
    assert sorted(got["summary"]) == sorted(want["summary"])
    for key, w in want["summary"].items():
        g = got["summary"][key]
        if not isinstance(w, dict):
            assert g == w
            continue
        assert g["n"] == w["n"], key
        atol = TOLERANCES[key.removesuffix("_2nd_half")]
        assert abs(g["mean"] - w["mean"]) <= atol, key


def test_replay_eval_defaults():
    args = cli.parse_args(["--log-dir", "RUN"])
    assert (args.n_frames, args.n_objects, tuple(args.image_shape),
            args.seed, args.n_votes, args.with_icp, args.bf16,
            args.segmenter, args.device) == (24, 5, (240, 320), 11, 3, False,
                                             False, None, "cuda")


# --------------------------------------------------------- align_pointclouds


def _table(text):
    """``(instance, class, ADD init, ADD icp)`` rows of the printed table."""
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0].isdigit():
            rows.append((int(parts[0]), int(parts[1]), float(parts[2]),
                         float(parts[3])))
    return rows


def test_align_pointclouds_matches_example(capsys):
    """Default flags, 20 iterations: the same instances and start ADDs, ICP's
    ADD within 2e-4 m (JAX's search patched to the exact sum)."""
    argv = ["--iterations", "20"]
    with mock.patch.object(jicp, "pairwise_sq_dist", _exact_pairwise), \
            mock.patch.object(sys, "argv", ["align_pointclouds.py"] + argv):
        runpy.run_path(os.path.join(EXAMPLES, "preliminary",
                                    "align_pointclouds.py"),
                       run_name="__main__")
    want = _table(capsys.readouterr().out)
    adds_init, adds_icp = cli_align.main(argv + ["--device", "cpu"])
    got = _table(capsys.readouterr().out)
    assert len(got) == len(want) == len(adds_icp) > 0
    for g, w, a_i, a_f in zip(got, want, adds_init, adds_icp):
        assert g[:3] == w[:3]
        assert abs(a_f - w[3]) <= REFINED_ATOL + 5e-5  # w is rounded
        assert abs(a_i - w[2]) <= 5e-5


@pytest.mark.parametrize("name", ["replay_eval", "align_pointclouds",
                                  "align_occupancy_grids"])
def test_entry_points_default_to_the_card(name, sequences, tmp_path):
    """Without ``--device`` the CLIs go to CUDA; with no card they fail
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from morefusion_tpu_torch.cli import align_occupancy_grids

    mains = dict(
        replay_eval=(cli.main, ["--log-dir", write_run(str(tmp_path / "run")),
                                "--sequence", sequences[1]]),
        align_pointclouds=(cli_align.main, ["--iterations", "1"]),
        align_occupancy_grids=(align_occupancy_grids.main, [
            "--voxel-dim", "8", "--iterations", "1"]))
    main, argv = mains[name]
    with pytest.raises((AssertionError, RuntimeError)):
        main(argv)
