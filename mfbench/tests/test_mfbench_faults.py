"""The check catches each fault a cell can have, planted underneath the
timed path at a tiny size on the CPU: a train step that leaves its state
unchanged, or that leaves half of the batch out of the loss and takes the
mean over the rest; a pose or a refined pose altered where it is made."""

from unittest import mock

import pytest

from mfbench.tests import tiny


def _half_batch(fn):
    def wrapped(**kw):
        B = kw["quaternion_pred"].shape[0]
        return fn(**{k: v[: B // 2] for k, v in kw.items()})
    return wrapped


def _frozen_state(create):
    def wrapped(model, lr):
        state = create(model, lr)
        state.optimizer.step = lambda *a, **k: None
        return state
    return wrapped


@pytest.mark.parametrize("name", ["mf_occ.train.b16", "posenet.train.b16"])
def test_half_batch_fails(name):
    from morefusion_tpu_torch.models import losses

    with mock.patch.object(losses, "pose_loss",
                           _half_batch(losses.pose_loss)), \
            mock.patch.object(losses, "occupancy_loss",
                              _half_batch(losses.occupancy_loss)):
        result, checks = tiny.run_tiny(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ["mf_occ.train.b16", "posenet.train.b16"])
def test_unchanged_state_fails(name):
    from morefusion_tpu_torch.training import trainer

    with mock.patch.object(trainer, "create_train_state",
                           _frozen_state(trainer.create_train_state)):
        result, checks = tiny.run_tiny(name)
    assert not result["correct"], checks
    change = [v for n, v, _ in checks if n.startswith("change")]
    assert change and change[0] >= 0.99, checks


@pytest.mark.parametrize("name", ["mf_occ.serve.scene8",
                                  "mf_occ.serve.pose8"])
def test_altered_pose_fails(name):
    from morefusion_tpu_torch.runtime import pose_estimation

    predict = pose_estimation.PoseEstimationNode._predict_frame

    def altered(self, *args):
        T, conf = predict(self, *args)
        T = T.clone()
        T[0, 0, 3] += 0.01  # one centimetre on the first instance
        return T, conf

    with mock.patch.object(pose_estimation.PoseEstimationNode,
                           "_predict_frame", altered):
        result, checks = tiny.run_tiny(name)
    assert not result["correct"], checks


def test_altered_refined_pose_fails():
    from morefusion_tpu_torch.contrib import collision_refine

    refine = collision_refine.refine_collision

    def altered(*args, **kw):
        q, t, losses, n = refine(*args, **kw)
        return q, t + 0.01, losses, n

    with mock.patch.object(collision_refine, "refine_collision", altered):
        result, checks = tiny.run_tiny("mf_occ.serve.scene8")
    assert not result["correct"], checks
    assert dict((n, v) for n, v, _ in checks)["pose"] == 0.0
