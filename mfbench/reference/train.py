"""The train step in plain PyTorch, followed step by step from the same
weights, CAD bank, batches and seed as the port's.

A frozen copy of ``morefusion_tpu_torch/training/trainer.py``'s step
(``step_generators``, ``make_loss_fn``, ``_make_step`` on one device): the
batch packed into the transfer form and unpacked on the device, the device
augmentation, the forward with dropout, ADD/ADD-S (knn in plain PyTorch),
the occupancy term (min-distance in plain PyTorch), the backward and Adam
(``torch.optim.Adam`` in its plain, per-parameter form).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import losses as losses_module
from .training import augment_device
from .training import transfer

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def step_generators(seed: int, step: int, device):
    """The (sampling, dropout, augmentation) generators of one step on
    rank 0, derived from ``(seed, step)``."""
    states = np.random.SeedSequence([seed, step]).generate_state(
        3, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


def model_inputs(model, batch):
    kwargs = dict(class_id=batch["class_id"], rgb=batch["rgb"],
                  pcd=batch["pcd"])
    if hasattr(model, "voxel_dim"):
        kwargs["pitch"] = batch["pitch"]
    if getattr(model, "with_occupancy", False):
        kwargs["origin"] = batch["origin"]
        kwargs["grid_nontarget_empty"] = batch["grid_nontarget_empty"]
    return kwargs


def unpacked(schema, host_batch, device):
    """The batch as the step sees it: packed on the host, unpacked on the
    device, its cloud rebuilt from depth and coefficients."""
    buf = torch.from_numpy(schema.pack(host_batch)).to(device)
    out = schema.unpack(buf)
    out["pcd"] = transfer.reconstruct_pcd(out.pop("z"), out.pop("pcd_coef"))
    return out


def loss(model, bank, batch, use_symmetric, occupancy_term, augment,
         generators, train=True):
    sample_gen, dropout_gen, augment_gen = generators
    if augment:
        batch["rgb"], batch["pcd"] = augment_device.augment_batch(
            augment_gen, batch["rgb"], batch["pcd"])
    quat, trans, conf = model(**model_inputs(model, batch),
                              generator=sample_gen, train=train,
                              dropout_generator=dropout_gen)
    cid = batch["class_id"].long()
    value = losses_module.pose_loss(
        quaternion_pred=quat, translation_pred=trans, confidence_pred=conf,
        quaternion_true=batch["quaternion_true"],
        translation_true=batch["translation_true"],
        cad_points=bank["points"][cid],
        symmetric=bank["symmetric"][cid] & use_symmetric)
    if occupancy_term:
        value = value + losses_module.occupancy_loss(
            quaternion_pred=quat, translation_pred=trans,
            confidence_pred=conf,
            solid_points=bank["solid_points"][cid],
            solid_sdf=bank["solid_sdf"][cid],
            solid_mask=bank["solid_mask"][cid], pitch=batch["pitch"],
            origin=batch["origin"], grid_target=batch["grid_target"],
            grid_nontarget_empty=batch["grid_nontarget_empty"])
    return value


def follow(model, bank, host_batches, seed, n_steps, learning_rate,
           occupancy_term, augment, use_symmetric):
    """``n_steps`` Adam steps of ``model`` on ``host_batches`` in turn.
    Returns the losses, each parameter's first gradient and its change
    after the steps, each by name."""
    device = next(model.parameters()).device
    schema = transfer.TransferSchema(host_batches[0])
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 betas=ADAM_BETAS, eps=ADAM_EPS,
                                 foreach=False)
    losses, first_grad = [], None
    for step in range(n_steps):
        batch = unpacked(schema, host_batches[step % len(host_batches)],
                         device)
        optimizer.zero_grad(set_to_none=True)
        value = loss(model, bank, batch, use_symmetric, occupancy_term,
                     augment, step_generators(seed, step, device))
        value.backward()
        if first_grad is None:
            first_grad = {n: p.grad.detach().clone()
                          for n, p in params.items()}
        optimizer.step()
        losses.append(float(value.detach()))
    change = {n: params[n].detach() - before[n] for n in params}
    return losses, first_grad, change
