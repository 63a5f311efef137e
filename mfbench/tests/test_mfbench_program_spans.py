"""The readers of the program's own spans and counters
(``layer_metrics/train.*``, ``pose.*`` over ``program_spans.py``) in tiny
traced runs on the CPU, where the device intervals are read from the
host's clock and no kernel is launched; untraced runs report none of them."""

import pytest

from mfbench import harness, program_spans, readers
from mfbench.tests import tiny

NEW = {
    "mf_occ.train.b16": ["train.forward_ms_p50", "train.backward_ms_p50",
                         "train.voxel_ms_p50"],
    "posenet.train.b16": ["train.forward_ms_p50", "train.backward_ms_p50"],
    "mf_occ.serve.pose8": ["pose.select_ms_p50", "pose.upload_ms_p50",
                           "pose.forward_ms_p50", "pose.lanes_useful_pct"],
}
# read from the card's kernel launches: None on the CPU
CARD_ONLY = {"mf_occ.train.b16": ["train.launches_per_step"],
             "posenet.train.b16": ["train.launches_per_step"],
             "mf_occ.serve.pose8": []}
SPANS = {
    "mf_occ.train.b16": ["trainer.step", "trainer.unpack", "trainer.augment",
                         "trainer.forward", "trainer.loss", "trainer.backward",
                         "trainer.optimizer", "model.backbone", "model.voxel",
                         "model.heads"],
    "posenet.train.b16": ["trainer.step", "trainer.unpack", "trainer.augment",
                          "trainer.forward", "trainer.loss",
                          "trainer.backward", "trainer.optimizer",
                          "model.backbone", "model.heads"],
    "mf_occ.serve.pose8": ["pose_node.select", "pose_node.upload",
                           "pose_node.predict", "pose_node.resolve",
                           "model.backbone", "model.voxel", "model.heads"],
}
CHILDREN = ("trainer.unpack", "trainer.augment", "trainer.forward",
            "trainer.loss", "trainer.backward", "trainer.optimizer")


def _run(name, trace, monkeypatch):
    """The tiny run's result and the ``harness.Run`` its readers got."""
    seen = {}
    read_metrics = harness.read_metrics

    def keep(cell, run, section):
        seen["run"] = run
        return read_metrics(cell, run, section)

    monkeypatch.setattr(harness, "read_metrics", keep)
    # a window long enough to reach the traced stretch on a loaded host
    result, _ = tiny.run_tiny(name, seed=2718281801, trace=trace,
                              seconds=5.0)
    return result, seen["run"]


def test_every_new_metric_is_listed_for_its_cells():
    for name, metrics in NEW.items():
        listed = {m["name"] for m in tiny.tiny_cell(name).per_layer}
        assert set(metrics) | set(CARD_ONLY[name]) <= listed, name
        for m in tiny.tiny_cell(name).per_layer:
            if m["name"] in metrics:
                assert m["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_run_reads_the_program_spans(name, monkeypatch):
    result, run = _run(name, True, monkeypatch)
    assert result["correct"]
    for metric in NEW[name]:
        assert metric in result["metrics"], metric
        assert result["metrics"][metric]["value"] > 0, metric
    for metric in CARD_ONLY[name]:
        assert metric not in result["metrics"], metric
    names = {n for n, _, _ in run.record.profile.host_spans}
    assert set(SPANS[name]) <= names
    rec = program_spans.recorded(run)
    if name.endswith("pose8"):
        frames = readers.profiled_units(run)
        instances = sum(u["instances"] for u in frames)
        assert result["metrics"]["pose.lanes_useful_pct"]["value"] == \
            pytest.approx(100.0 * instances / (8 * len(frames)))
        assert rec["counters"]["pose_node.lanes"] == 8 * len(frames)
    else:
        # the children's intervals lie inside the step's
        steps = rec["device_ms"]["trainer.step"]
        assert len(steps) == run.record.profile.units
        children = sum(sum(rec["device_ms"][c]) for c in CHILDREN)
        assert 0 < children <= sum(steps)


@pytest.mark.parametrize("name", sorted(NEW))
def test_untraced_run_reports_no_new_metric(name, monkeypatch):
    result, run = _run(name, False, monkeypatch)
    assert result["correct"]
    assert not set(result["metrics"]) & set(NEW[name] + CARD_ONLY[name])
    for metric in NEW[name]:
        path = tiny.ROOT / "mfbench" / "layer_metrics" / f"{metric}.py"
        assert harness.load_module(path, metric).read(run) is None
