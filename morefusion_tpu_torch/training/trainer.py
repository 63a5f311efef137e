"""The pose models' train and eval steps of the port (SingleView3D and
PoseNet), on one device and data parallel.

Port of ``morefusion_tpu/training/trainer.py`` (``CadPointBank``,
``make_train_step``, ``make_eval_step``, ``make_dp_train_step``,
``make_dp_eval_step``, ``create_train_state``, ``stack_examples``):

- Adam (``torch.optim.Adam``; betas 0.9 / 0.999 and eps 1e-8 are optax's
  defaults too) at a learning rate that is a number or a schedule of the
  step (a ``LambdaLR`` stepped after each update, so the update of step
  ``n`` uses ``schedule(n)``, as ``optax.adam(schedule)`` does);
- the ``add -> add/add_s`` schedule is the ``use_symmetric`` argument of
  the step, ANDed with the per-class symmetry table;
- the CAD point banks live on the device as ``(n_class + 1, N, 3)`` tables
  indexed by the one-based class id (row 0, the background, is zeros);
- each step draws its sampling, dropout and augmentation from generators
  derived from ``(seed, step)``, and on a rank r > 0 of a data-parallel
  step from ``(seed, step, r)``, where the JAX step folds the step and the
  device's index into its key and splits it;
- ``occupancy_loss_term`` adds the occupancy reward / penalty (the
  ``+occupancy`` losses); it defaults to the model's occupancy branch, as
  JAX's defaults to ``with_occupancy``;
- ``augment=True`` runs ``augment_device.augment_batch`` on the batch's rgb
  and pcd inside the step;
- with a ``transfer_schema`` the batch arrives as one packed uint8 buffer
  (``training/transfer.py``), unpacked and its cloud rebuilt in the step.

Fixed where the JAX functions take arguments: 500 CAD points per class
from seed 0, the confidence weight 0.015, the occupancy term at scale 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..datasets.ycb_video.class_names import symmetric_flags
from ..models import losses as losses_module
from ..parallel import DataMesh
from ..utils.profiling import annotate
from . import augment_device
from . import transfer as transfer_module

EVAL_SEED = 1234  # the JAX eval step's fixed sampling key
N_CAD_POINTS = 500  # CAD points per class in the bank
BANK_SEED = 0  # the host RNG that draws the bank's points
LEARNING_RATE = 1e-4


@dataclasses.dataclass
class CadPointBank:
    """Device-resident per-class CAD point tables.

    points: (n_class+1, n_points, 3) — row 0 (background) is zeros.
    solid_points/sdf/mask: (n_class+1, max_solid_points, ...) padded solid
    voxel points of each class for the occupancy loss.
    symmetric: (n_class+1,) bool.
    """

    points: torch.Tensor
    symmetric: torch.Tensor
    solid_points: torch.Tensor
    solid_sdf: torch.Tensor
    solid_mask: torch.Tensor

    @classmethod
    def build(
        cls,
        models,
        n_fg_class: int,
        max_solid_points: int = 3000,
        device="cuda",
    ) -> "CadPointBank":
        """The tables of ``models`` (a ``ModelsBase``), with the solid
        points, drawn on the host with ``np.random.RandomState(BANK_SEED)``
        as the JAX package draws them, then moved to ``device``. The tests
        keep fewer solid points per class than the 3000 of training."""
        rng = np.random.RandomState(BANK_SEED)
        pts = np.zeros((n_fg_class + 1, N_CAD_POINTS, 3), np.float32)
        for cid in range(1, n_fg_class + 1):
            pcd = models.get_pcd(cid)
            keep = rng.permutation(len(pcd))[:N_CAD_POINTS]
            if len(keep) < N_CAD_POINTS:
                keep = np.r_[
                    keep, rng.randint(0, len(pcd), N_CAD_POINTS - len(keep))
                ]
            pts[cid] = pcd[keep]

        sym = np.zeros(n_fg_class + 1, bool)
        sym[1:] = symmetric_flags(n_fg_class)

        solid_pts = np.zeros((n_fg_class + 1, max_solid_points, 3), np.float32)
        solid_sdf = np.zeros((n_fg_class + 1, max_solid_points), np.float32)
        solid_mask = np.zeros((n_fg_class + 1, max_solid_points), bool)
        for cid in range(1, n_fg_class + 1):
            grid = models.get_solid_voxel_grid(cid)
            p = grid.points
            d = grid.inside_distance
            if len(p) > max_solid_points:
                keep = rng.permutation(len(p))[:max_solid_points]
                p, d = p[keep], d[keep]
            solid_pts[cid, : len(p)] = p
            solid_sdf[cid, : len(p)] = d
            solid_mask[cid, : len(p)] = True

        def put(a):
            return torch.from_numpy(a).to(device)

        return cls(points=put(pts), symmetric=put(sym),
                   solid_points=put(solid_pts), solid_sdf=put(solid_sdf),
                   solid_mask=put(solid_mask))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), its optimizer, its learning-rate
    schedule and the step count."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def create_train_state(
    model, learning_rate: Union[float, Callable[[int], float]] = LEARNING_RATE
) -> TrainState:
    """Adam on ``model``'s parameters at ``learning_rate``: a number, or a
    function of the step count before the update (an optax schedule's
    contract)."""
    if callable(learning_rate):
        base, factor = 1.0, (lambda count: float(learning_rate(count)))
    else:
        base, factor = float(learning_rate), (lambda count: 1.0)
    optimizer = torch.optim.Adam(model.parameters(), lr=base,
                                 betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (the warmup included), as a
    function of the step count."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def step_generators(seed: int, step: int, device, rank: int = 0):
    """The (sampling, dropout, augmentation) generators of one step, on
    ``device``, derived from ``(seed, step)`` alone on rank 0 and from
    ``(seed, step, rank)`` on the other ranks of a data-parallel step, so
    that each rank draws its own streams and one process draws those of
    rank 0."""
    entropy = [seed, step] + ([rank] if rank else [])
    states = np.random.SeedSequence(entropy).generate_state(3, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


def _device_of(model):
    return next(model.parameters()).device


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _unpacked(batch, device, transfer_schema):
    """The batch's dict on ``device``; a packed buffer (a tensor, with a
    ``transfer_schema``) unpacked there, its cloud rebuilt."""
    if transfer_schema is None:
        return _to_device(batch, device)
    out = transfer_schema.unpack(torch.as_tensor(batch, device=device))
    out["pcd"] = transfer_module.reconstruct_pcd(out.pop("z"),
                                                 out.pop("pcd_coef"))
    return out


def _has_occupancy_branch(model):
    return getattr(model, "with_occupancy", False)


def _model_inputs(model, batch):
    """The forward's keyword inputs from ``batch``, as JAX's step picks
    them: ``pitch`` only for a model with a voxel grid (``voxel_dim``),
    the occupancy inputs only for a model with the occupancy branch."""
    kwargs = dict(class_id=batch["class_id"], rgb=batch["rgb"],
                  pcd=batch["pcd"],
                  sample_indices=batch.get("sample_indices"))
    if "pitch" in batch and hasattr(model, "voxel_dim"):
        kwargs["pitch"] = batch["pitch"]
    if _has_occupancy_branch(model):
        kwargs["origin"] = batch.get("origin")
        kwargs["grid_nontarget_empty"] = batch["grid_nontarget_empty"]
    return kwargs


def make_loss_fn(model, bank: CadPointBank,
                 occupancy_loss_term: Optional[bool] = None,
                 augment: bool = False, transfer_schema=None,
                 forward=None):
    """The train step's loss: ``loss_fn(batch, use_symmetric, *, train=True,
    sample_generator=None, dropout_generator=None,
    augment_generator=None) -> (loss, metrics)``.

    Batch contract (fixed shapes; arrays or tensors, moved to the model's
    device here): class_id (B,) int; rgb (B, H, W, 3) f32; pcd (B, H, W, 3)
    f32 (NaN holes); quaternion_true (B, 4); translation_true (B, 3); pitch
    (B,); origin (B, 3) [occupancy]; grid_target, grid_nontarget_empty
    (B, V, V, V) f32 [occupancy]; optionally sample_indices (B, n_point),
    which the model then uses in place of drawing its own.

    A model with a voxel grid (``voxel_dim``) gets ``pitch``, and one with
    the occupancy branch (``model.with_occupancy``) the occupancy grids;
    PoseNet gets neither. The occupancy reward / penalty joins the loss when
    ``occupancy_loss_term`` (default: the model's occupancy branch).
    ``augment`` augments rgb and pcd with ``augment_generator``
    (``augment_device.augment_batch``). With ``transfer_schema`` the batch
    is that schema's packed ``(B, K)`` uint8 buffer. ``forward`` is the
    module that runs the forward (a DDP wrapper of ``model``; default
    ``model``).
    """
    if occupancy_loss_term is None:
        occupancy_loss_term = _has_occupancy_branch(model)
    forward = model if forward is None else forward

    def loss_fn(batch, use_symmetric, *, train: bool = True,
                sample_generator=None, dropout_generator=None,
                augment_generator=None):
        with annotate("trainer.unpack"):
            batch = _unpacked(batch, _device_of(model), transfer_schema)
        if augment:
            with annotate("trainer.augment"):
                batch["rgb"], batch["pcd"] = augment_device.augment_batch(
                    augment_generator, batch["rgb"], batch["pcd"])
        with annotate("trainer.forward"):
            quat, trans, conf = forward(
                **_model_inputs(model, batch), generator=sample_generator,
                train=train, dropout_generator=dropout_generator)
        with annotate("trainer.loss"):
            cid = batch["class_id"].long()
            loss = losses_module.pose_loss(
                quaternion_pred=quat,
                translation_pred=trans,
                confidence_pred=conf,
                quaternion_true=batch["quaternion_true"],
                translation_true=batch["translation_true"],
                cad_points=bank.points[cid],
                symmetric=bank.symmetric[cid] & use_symmetric,
            )
            metrics = {"loss_add": loss}
            if occupancy_loss_term:
                occ = losses_module.occupancy_loss(
                    quaternion_pred=quat,
                    translation_pred=trans,
                    confidence_pred=conf,
                    solid_points=bank.solid_points[cid],
                    solid_sdf=bank.solid_sdf[cid],
                    solid_mask=bank.solid_mask[cid],
                    pitch=batch["pitch"],
                    origin=batch["origin"],
                    grid_target=batch["grid_target"],
                    grid_nontarget_empty=batch["grid_nontarget_empty"],
                )
                loss = loss + occ
                metrics["loss_occupancy"] = occ
            metrics["loss"] = loss
            return loss, metrics

    return loss_fn


def make_train_step(model, bank: CadPointBank,
                    occupancy_loss_term: Optional[bool] = None,
                    augment: bool = False, transfer_schema=None):
    """``train_step(state, batch, use_symmetric, seed=0) -> (state,
    metrics)``: one Adam step on the loss of ``make_loss_fn(model, bank,
    occupancy_loss_term, augment, transfer_schema)`` with dropout on, at the
    schedule's learning rate for ``state.step``. ``state`` is updated in
    place and returned; ``metrics`` are detached scalars on the device.
    """
    return _make_step(model, bank, None, occupancy_loss_term, augment,
                      transfer_schema)


def make_dp_train_step(model, bank: CadPointBank, mesh: DataMesh,
                       occupancy_loss_term: Optional[bool] = None,
                       augment: bool = False, transfer_schema=None):
    """The data-parallel train step, ``train_step(state, batch,
    use_symmetric, seed=0) -> (state, metrics)``, where ``batch`` is this
    rank's shard (``parallel.shard_batch``, or its slice of the packed
    buffer).

    Each rank runs the single-device step of ``make_train_step`` on its
    shard, with its own generators (``step_generators(seed, step, device,
    mesh.rank)``). Under a process group the forward runs through
    ``DistributedDataParallel``, which replicates rank 0's parameters when
    it wraps the model and averages the gradients over the ranks in the
    backward, as JAX's ``lax.pmean`` does; the metrics are averaged by an
    ``all_reduce``. Without one (a single process) the step is the
    single-device step, as a one-device mesh makes JAX's. Every parameter
    of SingleView3D (tiny and full width, with or without the occupancy
    branch and term), PoseNet and the segmenter's UNet gets a gradient in
    every step, so DDP runs with ``find_unused_parameters=False`` (a model
    that left one out would fail in its second step). The models hold no
    buffers, so DDP's buffer broadcast moves nothing.
    """
    return _make_step(model, bank, mesh, occupancy_loss_term, augment,
                      transfer_schema)


def wrap_ddp(model, mesh: Optional[DataMesh]):
    """``model`` under ``DistributedDataParallel`` when ``mesh`` is under a
    process group, else None (see ``make_dp_train_step``)."""
    if mesh is None or not mesh.distributed:
        return None
    return torch.nn.parallel.DistributedDataParallel(
        model, find_unused_parameters=False)


def all_reduce_mean(metrics: dict, mesh: Optional[DataMesh]) -> dict:
    """The mean over the ranks of a dict of scalar tensors, in one
    ``all_reduce`` (the dict itself without a process group)."""
    if mesh is None or not mesh.distributed or mesh.world_size == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    torch.distributed.all_reduce(flat)
    flat = flat / mesh.world_size
    return {k: flat[i] for i, k in enumerate(keys)}


def _make_step(model, bank, mesh, occupancy_loss_term, augment,
               transfer_schema):
    ddp = wrap_ddp(model, mesh)
    rank = mesh.rank if mesh is not None else 0
    loss_fn = make_loss_fn(model, bank, occupancy_loss_term, augment,
                           transfer_schema, forward=ddp)

    def train_step(state: TrainState, batch, use_symmetric, seed: int = 0):
        with annotate("trainer.step"):
            device = _device_of(state.model)
            sample_gen, dropout_gen, augment_gen = step_generators(
                seed, state.step, device, rank)
            state.optimizer.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(batch, use_symmetric,
                                    sample_generator=sample_gen,
                                    dropout_generator=dropout_gen,
                                    augment_generator=augment_gen)
            with annotate("trainer.backward"):
                loss.backward()
            with annotate("trainer.optimizer"):
                state.optimizer.step()
                state.scheduler.step()
            state.step += 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            return state, all_reduce_mean(metrics, mesh)

    train_step.ddp = ddp
    return train_step


def make_eval_step(model, bank: CadPointBank, transfer_schema=None):
    """``eval_step(batch) -> {add, add_s, add_or_add_s, class_id}``, each
    ``(B,)``: the best-confidence pose of a forward without dropout, its
    points sampled from a generator seeded with the JAX eval step's fixed
    seed. With ``transfer_schema`` the batch is its packed buffer."""

    def eval_step(batch):
        device = _device_of(model)
        generator = torch.Generator(device=device).manual_seed(EVAL_SEED)
        with torch.no_grad():
            batch = _unpacked(batch, device, transfer_schema)
            quat, trans, conf = model(**_model_inputs(model, batch),
                                      generator=generator)
            cid = batch["class_id"].long()
            out = losses_module.evaluate_add(
                quaternion_pred=quat,
                translation_pred=trans,
                confidence_pred=conf,
                quaternion_true=batch["quaternion_true"],
                translation_true=batch["translation_true"],
                cad_points=bank.points[cid],
                symmetric=bank.symmetric[cid],
            )
        out["class_id"] = batch["class_id"]
        return out

    return eval_step


def make_dp_eval_step(model, bank: CadPointBank, mesh: DataMesh,
                      transfer_schema=None):
    """The data-parallel eval step: ``make_eval_step`` on this rank's shard,
    its records left on the rank (JAX's ``shard_map``ped eval reseeds every
    device with the same fixed key, as each rank here reseeds with
    ``EVAL_SEED``). ``training.loop.fit`` gathers the records to rank 0."""
    del mesh  # no collective: each rank evaluates its own rows
    return make_eval_step(model, bank, transfer_schema)


def stack_examples(examples):
    """Host-side batch collation: list of dicts -> dict of stacked arrays."""
    return {k: np.stack([np.asarray(e[k]) for e in examples])
            for k in examples[0]}
