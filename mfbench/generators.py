"""Inputs and weights of every cell, made from the cell's seed.

The program and the plain reference are handed what these functions make;
neither makes its own. Everything a run needs follows from ``--seed``:
the same seed gives the same weights, CAD bank, batches and frames, and
every seed gives the same sizes (only values and orders change).

- ``weights``: every parameter of a model, drawn on the device in one call
  and scaled per leaf (LeCun-uniform for matrices and kernels, +-0.01 for
  vectors: biases and PReLU slopes).
- ``cad_bank``: 21 box-shaped CAD models on the device: 500 surface points
  a class, up to 3000 solid points a class with their inside distance, and
  the symmetric classes of the configuration.
- ``train_batch``: the JAX package's synthetic train batch (``make_batch``
  of ``examples/profile_train.py``, as ``chip_smoke.py::make_train_batch``
  copied it), in the transfer form's fields: an organized cloud with about
  35% holes as depth and its affine coefficients, 32^3 grids about 5%
  target and about 30% no-entry.
- ``scene_frame``: a 480x640 RGB-D frame with 5 to 8 box objects of distinct
  classes seen by a 525 px camera, each with its instance label, true pose,
  and 32^3 target and no-entry grids (``chip_smoke.py::make_frame`` and
  ``make_icc_scene``, copied and merged).
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_CLASS = 21
N_CAD_POINTS = 500
MAX_SOLID_POINTS = 3000
FOCAL = 525.0


def rng(seed: int, *stream: int) -> np.random.RandomState:
    """A host generator for ``stream`` of ``seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed), *stream]).generate_state(1)
    return np.random.RandomState(int(state[0]))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


# ------------------------------------------------------------------ weights

WEIGHT_STREAM = 1


def weight_scales(shapes):
    """Each leaf's bound: sqrt(3 / fan_in) for a matrix or kernel, 0.01 for
    a vector (bias, PReLU slope)."""
    out = []
    for shape in shapes:
        if len(shape) >= 2:
            out.append(math.sqrt(3.0 / int(np.prod(shape[1:]))))
        else:
            out.append(0.01)
    return out


def weights(named_shapes, seed: int, device) -> dict:
    """``{name: tensor}`` for ``named_shapes`` (a list of ``(name, shape)``
    in a fixed order), uniform in each leaf's bound, drawn in one call."""
    shapes = [tuple(s) for _, s in named_shapes]
    sizes = [int(np.prod(s)) for s in shapes]
    g = device_generator(seed, WEIGHT_STREAM, device)
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    out = {}
    for (name, shape), part, scale in zip(
            named_shapes, torch.split(flat, sizes), weight_scales(shapes)):
        out[name] = (part * scale).reshape(shape)
    return out


def load_weights(model, seed: int):
    """Overwrite every parameter of ``model`` with ``weights`` of its
    names and shapes (sorted by name, so that two models with the same
    parameter tree get the same values)."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    named = sorted((n, tuple(p.shape)) for n, p in params.items())
    with torch.no_grad():
        for name, value in weights(named, seed, device).items():
            params[name].copy_(value)
    return model


# ------------------------------------------------------------------ CAD bank

BANK_STREAM = 2


def cad_bank(seed: int, symmetric_classes, device,
             max_solid: int = MAX_SOLID_POINTS) -> dict:
    """The bank's tables, row 0 (background) zeros: ``points (22, 500, 3)``
    on each box's surface, ``solid_points (22, max_solid, 3)`` inside it
    with ``solid_sdf`` their distance to the surface and ``solid_mask``
    (between half and all of ``max_solid`` valid a class), ``symmetric
    (22,)``, ``half_extent (22, 3)`` and ``diagonal (22,)``, the bounding
    box's diagonal (the port's voxel pitch is the diagonal over the grid's
    voxels a side)."""
    g = device_generator(seed, BANK_STREAM, device)
    C = N_CLASS + 1
    half = 0.02 + 0.06 * torch.rand((C, 3), generator=g, device=device)
    solid = (torch.rand((C, max_solid, 3), generator=g, device=device)
             * 2.0 - 1.0) * half[:, None]
    sdf = (half[:, None] - solid.abs()).amin(-1)
    n_solid = torch.randint(max_solid // 2, max_solid + 1, (C,), generator=g,
                            device=device)
    mask = torch.arange(max_solid, device=device)[None] < n_solid[:, None]
    surface = (torch.rand((C, N_CAD_POINTS, 3), generator=g, device=device)
               * 2.0 - 1.0) * half[:, None]
    axis = torch.randint(0, 3, (C, N_CAD_POINTS), generator=g, device=device)
    side = torch.where(torch.rand((C, N_CAD_POINTS), generator=g,
                                  device=device) < 0.5, -1.0, 1.0)
    on_face = torch.nn.functional.one_hot(axis, 3).bool()
    surface = torch.where(on_face, side[..., None] * half[:, None], surface)
    symmetric = torch.zeros(C, dtype=torch.bool, device=device)
    symmetric[list(symmetric_classes)] = True
    zero = torch.zeros((), device=device)
    bank = dict(points=surface, solid_points=solid,
                solid_sdf=torch.where(mask, sdf, zero), solid_mask=mask,
                symmetric=symmetric, half_extent=half,
                diagonal=2.0 * half.norm(dim=-1))
    bank["solid_points"] = torch.where(mask[..., None], solid, zero)
    for k in ("points", "solid_points", "solid_sdf", "solid_mask",
              "half_extent"):
        bank[k][0] = 0
    return bank


# --------------------------------------------------------------- train batch


def quaternion_matrix_np(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def train_batch(seed: int, index: int, B: int, S: int, V: int,
                hole_rate: float, target_rate: float,
                noentry_rate: float) -> dict:
    """Batch ``index`` of the pool of ``seed``: the transfer form's fields
    on the host. rgb ``(B, S, S, 3)`` uint8; ``z (B, S, S)`` float32, a
    tilted plane at about 0.8 m with NaN holes at ``hole_rate``; ``pcd_coef
    (B, 4)``, the camera's ``x = z (a + b j)``, ``y = z (c + d i)``; class
    ids uniform over the 21 classes; a random true pose near 0.8 m; origin
    and pitch of the grid; bool grids at ``target_rate`` and
    ``noentry_rate``."""
    r = rng(seed, 10, index)
    c = (S - 1) / 2.0
    ii, jj = np.mgrid[0:S, 0:S].astype(np.float32)
    tilt = r.uniform(-3e-4, 3e-4, (B, 2)).astype(np.float32)
    z = (r.uniform(0.7, 0.9, (B, 1, 1)).astype(np.float32)
         + tilt[:, 0, None, None] * (ii - c) + tilt[:, 1, None, None] * (jj - c)
         + r.normal(0, 0.01, (B, S, S)).astype(np.float32))
    z[r.rand(B, S, S) < hole_rate] = np.nan
    f = r.uniform(0.8, 1.2, (B, 1)) * FOCAL
    coef = np.concatenate([-c / f, 1.0 / f, -c / f, 1.0 / f], 1)
    q = r.randn(B, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        rgb=r.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
        z=z.astype(np.float32),
        pcd_coef=coef.astype(np.float32),
        grid_target=r.rand(B, V, V, V) < target_rate,
        grid_nontarget_empty=r.rand(B, V, V, V) < noentry_rate,
        class_id=r.randint(1, N_CLASS + 1, B).astype(np.int32),
        quaternion_true=q.astype(np.float32),
        translation_true=(r.uniform(-0.1, 0.1, (B, 3))
                          + [0, 0, 0.8]).astype(np.float32),
        origin=(r.uniform(-0.2, 0.0, (B, 3)) + [0, 0, 0.7]).astype(
            np.float32),
        pitch=np.full(B, 0.01, np.float32),
    )


# -------------------------------------------------------------------- frames


def _grid(points, origin, pitch, V):
    """``(V, V, V)`` uint8 grid, 255 where a point falls."""
    idx = np.round((points - origin) / pitch).astype(np.int64)
    idx = idx[((idx >= 0) & (idx < V)).all(1)]
    grid = np.zeros((V, V, V), np.uint8)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 255
    return grid


def object_counts(seed: int, pool: int, lo: int, hi: int):
    """The number of objects of each frame of a pool: ``lo`` to ``hi`` in
    turn, so that every seed gets the same counts, in the seed's order."""
    counts = [lo + k % (hi - lo + 1) for k in range(pool)]
    return [int(n) for n in rng(seed, 21).permutation(counts)]


def scene_frame(seed: int, index: int, bank_host: dict, H: int, W: int,
                n: int, V: int, hole_rate: float) -> dict:
    """Frame ``index`` of the pool of ``seed``: ``n`` boxes of distinct
    classes side by side on a table at
    0.7-0.9 m, each seen as an elliptic patch of its own colour (the
    instance label is the ground truth). Returns the frame's ``rgb`` (H, W,
    3) uint8, ``pcd`` (H, W, 3) float32 with NaN holes, ``label`` (H, W)
    int32, ``instance_to_class``, and per instance (in instance order) the
    true pose ``T_true``, the grid's ``pitch`` and ``origin``, and the
    uint8 ``target`` and ``noentry`` grids: the instance's own observed
    points, and the others' points and the free space in front of the
    surface."""
    r = rng(seed, 20, index)
    classes = r.choice(np.arange(1, N_CLASS + 1), n, replace=False)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (1.0 + 0.0003 * (v - cy)).astype(np.float32)
    rgb = np.clip(100 + r.normal(0, 12, (H, W, 3)), 0, 255)
    label = np.zeros((H, W), np.int32)
    poses = []
    for k in range(n):
        uc = (k + 0.5) * W / n + r.uniform(-20, 20) * W / 640
        vc = H / 2.0 + r.uniform(-80, 80) * H / 480
        z0 = r.uniform(0.7, 0.9)
        half = bank_host["half_extent"][classes[k]]
        a, b = (FOCAL * half[:2] / z0).clip(12, 0.45 * W / n)
        rr = ((u - uc) / a) ** 2 + ((v - vc) / b) ** 2
        inside = (rr < 1.0) & (label == 0)
        depth[inside] = z0 - half[2] * np.sqrt(1.0 - rr[inside])
        label[inside] = k + 1
        color = r.uniform(30, 225, 3)
        rgb[inside] = np.clip(color + r.normal(0, 20, (inside.sum(), 3)),
                              0, 255)
        T = np.eye(4)
        T[:3, :3] = quaternion_matrix_np(r.randn(4))
        T[:3, 3] = [(uc - cx) * z0 / FOCAL, (vc - cy) * z0 / FOCAL, z0]
        poses.append(T)
    depth[r.rand(H, W) < hole_rate] = np.nan
    pcd = np.stack([(u - cx) * depth / FOCAL, (v - cy) * depth / FOCAL,
                    depth], -1).astype(np.float32)

    finite = np.isfinite(pcd).all(-1)
    observed = [pcd[(label == k + 1) & finite] for k in range(n)]
    # free space: samples of each pixel's ray in front of its surface
    rays = pcd[finite][r.choice(int(finite.sum()), 20000)]
    free = rays[:, None] * r.uniform(0.8, 0.98, (1, 4, 1))
    free = free.reshape(-1, 3).astype(np.float32)
    pitch, origin, target, noentry = [], [], [], []
    for k in range(n):
        p = float(bank_host["diagonal"][classes[k]]) / V
        o = (poses[k][:3, 3] - p * (V / 2.0 - 0.5)).astype(np.float32)
        others = np.concatenate(
            [observed[j] for j in range(n) if j != k] + [free])
        pitch.append(p)
        origin.append(o)
        target.append(_grid(observed[k], o, p, V))
        noentry.append(_grid(others, o, p, V))
    return dict(rgb=rgb.astype(np.uint8), pcd=pcd, label=label,
                instance_to_class={k + 1: int(c) for k, c in
                                   enumerate(classes)},
                T_true=np.stack(poses), pitch=np.asarray(pitch, np.float32),
                origin=np.stack(origin), target=np.stack(target),
                noentry=np.stack(noentry))
