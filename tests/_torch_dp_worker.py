"""One rank of the port's data-parallel tests (``test_torch_parallel.py``).

    python -m tests._torch_dp_worker --rank R --world 2 --port P --dir D

Joins a ``gloo`` process group on the CPU, runs the collectives, the
SingleView3D data-parallel train and eval steps, the segmenter's DDP step
and ``fit``, and pickles what it saw to ``D/rank{R}.pkl``. It imports no
JAX. The inputs (the batches and the packed set) are those the test wrote
under ``D``; the helpers below make the draws of both packages the same:
the points are sampled by fixed per-pixel scores, and dropout is off.
"""

import argparse
import os
import pickle
from unittest import mock

import numpy as np
import torch

V = 32
SYMMETRIC_CLASS, ASYMMETRIC_CLASS = 13, 2


def fixed_scores(n_pixel: int) -> np.ndarray:
    """The per-pixel scores of the patched point sampler."""
    return np.random.RandomState(123).rand(n_pixel).astype(np.float32)


def torch_fixed_sampler(mask, n_point, generator=None):
    """``models.sampling.sample_mask_indices`` with fixed scores in place
    of the generator's draw (the same pick as :func:`jax_fixed_sampler`)."""
    B, H, W = mask.shape
    flat = mask.reshape(B, H * W)
    scores = torch.from_numpy(fixed_scores(H * W)).to(mask.device)
    scores = torch.where(flat, scores[None].expand(B, -1), float("-inf"))
    idx = torch.topk(scores, n_point, dim=1).indices
    n_valid = flat.sum(dim=1, keepdim=True).clamp_min(1)
    slot = torch.arange(n_point, device=mask.device)[None, :]
    wrapped = torch.where(slot < n_valid, slot, slot % n_valid)
    return torch.gather(idx, 1, wrapped)


def no_dropout(x, rate, generator):
    return x


def pose_batch(B=4, S=64, seed=0):
    """A global batch of the tiny SingleView3D: both classes twice, 30% NaN
    holes, random occupancy grids."""
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 255, (B, S, S, 3)).astype(np.float32)
    pcd = rng.uniform(-0.08, 0.08, (B, S, S, 3)).astype(np.float32)
    pcd[..., 2] += 0.8
    pcd[rng.rand(B, S, S) < 0.3] = np.nan
    q = rng.normal(size=(B, 4)).astype(np.float32)
    pitch = np.full(B, 0.01, np.float32)
    cid = np.array([SYMMETRIC_CLASS, ASYMMETRIC_CLASS] * (B // 2), np.int32)
    return dict(
        class_id=cid, rgb=rgb, pcd=pcd,
        quaternion_true=q / np.linalg.norm(q, axis=1, keepdims=True),
        translation_true=np.float32(rng.uniform(-0.02, 0.02, (B, 3))
                                    + [0, 0, 0.8]),
        origin=np.float32(np.array([0, 0, 0.8]) - pitch[:, None] * 15.5),
        pitch=pitch,
        grid_target=(rng.rand(B, V, V, V) < 0.2).astype(np.float32),
        grid_nontarget_empty=(rng.rand(B, V, V, V) < 0.3).astype(np.float32),
    )


def seg_batch(B=4, H=32, W=32, seed=0):
    """A segmenter batch whose two halves differ in foreground: the first
    two images hold ~5% foreground pixels, the last two ~80%."""
    rng = np.random.RandomState(seed)
    fg_share = np.array([0.05, 0.05, 0.8, 0.8])[:B]
    fg = rng.rand(B, H, W) < fg_share[:, None, None]
    label = np.where(fg, rng.randint(1, 22, (B, H, W)), 0)
    label[rng.rand(B, H, W) < 0.02] = -1  # ignored pixels
    return dict(
        rgb=rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8),
        class_label=label.astype(np.int8),
        boundary=(rng.rand(B, H, W) < 0.1).astype(np.uint8),
    )


SEG_WIDTHS = (8, 16)
FG_WEIGHT = 3.0


def _host(t):
    return t.detach().cpu().numpy()


def tiny_model(with_occupancy=True):
    from morefusion_tpu_torch import models

    torch.manual_seed(0)
    return models.tiny_singleview3d(21, n_point=32,
                                    with_occupancy=with_occupancy)


def tiny_unet(root):
    """The narrow UNet with the weights the test wrote (JAX's init)."""
    from morefusion_tpu_torch.models.segmentation import UNetSegmentation

    model = UNetSegmentation(n_class=22, widths=SEG_WIDTHS,
                             with_boundary=True, use_depth=False)
    model.load_state_dict(torch.load(os.path.join(root, "unet.pt")),
                          strict=True)
    return model


def small_bank():
    from morefusion_tpu_torch.datasets import ProceduralModels
    from morefusion_tpu_torch.training import trainer

    return trainer.CadPointBank.build(ProceduralModels(), 21,
                                      max_solid_points=400, device="cpu")


class OffsetLoader:
    """``BatchLoader`` that reads one batch when made, as JAX's ``fit``
    does for ``model.init`` (a shuffle and that batch's host draws): its
    epoch e is then JAX's epoch e."""

    def __new__(cls, *args, **kw):
        from morefusion_tpu_torch.training.data import BatchLoader

        loader = BatchLoader(*args, **kw)
        if kw.get("shuffle", True):
            next(iter(loader))
        return loader


def collectives(mesh):
    from morefusion_tpu_torch import parallel

    out = dict(is_primary=parallel.is_primary(),
               broadcast=parallel.broadcast_obj({"from": mesh.rank}),
               gather=parallel.gather_obj(("rank", mesh.rank)),
               slice=parallel.local_batch_slice(16))
    try:
        parallel.gather_obj(b"x" * 2000, size=1024)
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)
    parallel.barrier()
    t = torch.full((3,), float(mesh.rank + 1))
    module = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(module.weight, float(mesh.rank))
    parallel.replicate(t, mesh)
    parallel.replicate(module, mesh)
    out["replicated"] = _host(t), _host(module.weight)
    shard = parallel.shard_batch({"a": np.arange(8)}, mesh)
    out["shard"] = _host(shard["a"])
    return out


def dp_steps(mesh, batch):
    from morefusion_tpu_torch import parallel
    from morefusion_tpu_torch.training import trainer

    model = tiny_model()
    bank = small_bank()
    state = trainer.create_train_state(model)
    step = trainer.make_dp_train_step(model, bank, mesh,
                                      occupancy_loss_term=True)
    shard = parallel.shard_batch(batch, mesh)
    out = dict(metrics=[], find_unused=step.ddp.find_unused_parameters)
    for k in range(2):
        state, metrics = step(state, shard, True, seed=0)
        out["metrics"].append({k2: float(v) for k2, v in metrics.items()})
        if k == 0:
            out["grads"] = {n: None if p.grad is None else _host(p.grad)
                            for n, p in model.named_parameters()}
    out["params"] = {n: _host(p) for n, p in model.named_parameters()}
    out["draws"] = [_host(torch.rand(4, generator=g)) for g in
                    trainer.step_generators(0, 0, "cpu", mesh.rank)]
    eval_step = trainer.make_dp_eval_step(model, bank, mesh)
    out["eval"] = {k: _host(v) for k, v in eval_step(shard).items()}
    return out


def seg_steps(mesh, batch, root):
    from morefusion_tpu_torch import parallel
    from morefusion_tpu_torch.cli import train_segmentation as cli
    from morefusion_tpu_torch.training import trainer

    model = tiny_unet(root)
    state = trainer.create_train_state(model, 1e-3)
    step = cli.make_train_step(state, fg_weight=FG_WEIGHT, mesh=mesh)
    rows = parallel.local_batch_slice(len(batch["rgb"]), mesh)
    shard = {k: v[rows] for k, v in batch.items()}
    losses, grads = [], None
    for _ in range(2):
        losses.append(float(step(shard)))
        if grads is None:
            grads = {n: _host(p.grad) for n, p in model.named_parameters()}
    return dict(losses=losses, grads=grads)


def fit_run(mesh, root):
    from morefusion_tpu_torch import datasets
    from morefusion_tpu_torch.training import loop

    model = tiny_model(with_occupancy=False)
    out_dir = os.path.join(root, f"fit_rank{mesh.rank}")
    data = os.path.join(root, "packed")
    with mock.patch.object(loop, "BatchLoader", OffsetLoader):
        state, summary = loop.fit(
            model=model, models_bank=datasets.ProceduralModels(),
            train_dataset=datasets.PackedPoseDataset(data),
            val_dataset=datasets.PackedPoseDataset(data, split="val"),
            out_dir=out_dir,
            transform_train=datasets.Transform(True, False),
            transform_val=datasets.Transform(False, False),
            n_fg_class=21, batch_size=4, epochs=2, eval_interval=1.0,
            log_interval=1, val_batch_size=4, device="cpu")
    return dict(step=state.step, summary=summary,
                params={n: _host(p) for n, p in model.named_parameters()})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--dir", required=True)
    args = parser.parse_args(argv)
    torch.set_num_threads(2)

    from morefusion_tpu_torch import parallel
    from morefusion_tpu_torch.models import pspnet, singleview_3d

    parallel.maybe_initialize(init_method=f"tcp://127.0.0.1:{args.port}",
                              world_size=args.world, rank=args.rank,
                              backend="gloo")
    mesh = parallel.data_mesh("cpu")
    with np.load(os.path.join(args.dir, "inputs.npz")) as f:
        inputs = dict(f)
    pose = {k[5:]: v for k, v in inputs.items() if k.startswith("pose_")}
    seg = {k[4:]: v for k, v in inputs.items() if k.startswith("seg_")}
    res = dict(mesh=(mesh.world_size, mesh.rank, str(mesh.device)))
    res["collectives"] = collectives(mesh)
    with mock.patch.object(singleview_3d, "sample_mask_indices",
                           torch_fixed_sampler), \
            mock.patch.object(pspnet, "dropout", no_dropout):
        res["dp"] = dp_steps(mesh, pose)
        res["seg"] = seg_steps(mesh, seg, args.dir)
        res["fit"] = fit_run(mesh, args.dir)
    with open(os.path.join(args.dir, f"rank{args.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
