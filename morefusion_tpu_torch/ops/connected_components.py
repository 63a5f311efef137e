"""Connected components of a class map on the device: min-label propagation.

Port of ``morefusion_tpu/ops/connected_components.py``, in stock PyTorch
ops (it is no Pallas kernel in JAX either):

  1. every foreground pixel starts labelled with its own linear index;
  2. each step takes the minimum label over the 8-neighbourhood, among
     neighbours of the same class only (components never bleed across
     classes);
  3. two pointer-jumping hops ``label = label[label]`` (labels are linear
     indices) shorten label chains;
  4. the steps repeat until nothing changes, or ``max_iters`` steps.

With a boundary map, components form on ``class & ~boundary`` first; then
the carved pixels are flooded from the frozen cores. The result, the
minimum linear index of each component (-1 in background), is the unique
fixed point, so it equals JAX's bit for bit whenever JAX converges within
``max_iters``.

JAX runs the loop in one ``lax.while_loop`` on the device. Here the host
must read the "changed" flag to stop, so it reads the flags of
``CHECK_EVERY`` steps at once: steps after the fixed point change nothing.
The flags say which step first changed nothing, so the steps are counted
exactly and the ``max_iters`` cap cuts where JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 2 ** 31 - 1  # int32 max, JAX's sentinel
CHECK_EVERY = 8  # propagation steps between host reads
# the 8 neighbours as (dy, dx)
_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)]


def _neighbors(x, fill):
    """``(8, H, W)``: at ``[k, y, x]`` the value of ``x`` at the k-th
    neighbour of ``(y, x)``, ``fill`` beyond the edge."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return torch.stack([p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                        for dy, dx in _OFFSETS])


def _compress(labels):
    """One pointer-jumping hop: each label becomes its pixel's label."""
    flat = labels.reshape(-1)
    big = flat == _BIG
    jumped = torch.where(big, flat, flat[torch.where(big, 0, flat)])
    return jumped.reshape(labels.shape)


def _step(labels, same, update):
    """One propagation step over the pixels of ``update``; ``same (8, H, W)``
    marks the same-class neighbours."""
    nb = torch.where(same, _neighbors(labels, _BIG), _BIG).amin(dim=0)
    new = torch.where(update, torch.minimum(labels, nb), labels)
    # frozen pixels (update False) must not jump: their labels are final
    return torch.where(update, _compress(_compress(new)), new)


def _propagate(labels, same, update, max_iters, stats):
    it = 0
    while it < max_iters:
        flags = []
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            new = _step(labels, same, update)
            flags.append((new != labels).any())
            labels = new
        changed = torch.stack(flags).cpu()  # the one host read of the chunk
        stats["host_reads"] += 1
        still = torch.nonzero(~changed)
        if len(still):
            it += int(still[0]) + 1
            break
        it += len(flags)
    stats["iterations"].append(it)
    return labels


def connected_components(class_map, boundary=None, max_iters: int = 256,
                         return_stats: bool = False):
    """Per-class 8-connected components of a dense class map.

    ``class_map (H, W)`` integer, 0 = background; ``boundary (H, W)`` bool,
    optional: instance-separating pixels, flooded from the nearest
    (geodesic) surviving core. Returns ``(H, W)`` int32 component keys, the
    minimal linear index of each component, -1 in background; with
    ``return_stats`` also ``{"iterations": [steps of each propagation],
    "host_reads": n}``.
    """
    H, W = class_map.shape
    class_map = class_map.to(torch.int64)
    fg = class_map > 0
    idx = torch.arange(H * W, device=class_map.device).reshape(H, W)
    same = _neighbors(class_map, -1) == class_map
    stats = {"iterations": [], "host_reads": 0}
    big = torch.full_like(idx, _BIG)

    if boundary is None:
        labels = _propagate(torch.where(fg, idx, big), same, fg, max_iters,
                            stats)
    else:
        core = fg & ~boundary.to(torch.bool)
        labels = _propagate(torch.where(core, idx, big), same, core,
                            max_iters, stats)
        # only the carved pixels update, so cores cannot merge across a
        # boundary; a carved pixel with no reachable core stays background
        labels = _propagate(labels, same, fg & ~core, max_iters, stats)
    comp = torch.where(labels == _BIG, -1, labels).to(torch.int32)
    return (comp, stats) if return_stats else comp


def relabel_components(comp, class_map, min_area: int = 50):
    """Host finalize: component keys -> consecutive instance ids.

    Returns ``(instance_label (H, W) int32 with -1 background,
    {instance_id: class_id})``, the ``SegmentationNode`` contract.
    """
    import numpy as np

    comp = np.asarray(comp)
    class_map = np.asarray(class_map)
    flat = comp.ravel()
    keys, inv, counts = np.unique(
        flat, return_inverse=True, return_counts=True
    )
    keep = (keys >= 0) & (counts >= min_area)
    new_ids = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    instance_label = new_ids[inv].reshape(comp.shape)
    instance_to_class = {}
    flat_cls = class_map.ravel()
    first_pix = {}
    for k_i, key in enumerate(keys):
        if keep[k_i]:
            first_pix[int(new_ids[k_i])] = int(key)
    for iid, key in first_pix.items():
        instance_to_class[iid] = int(flat_cls[key])
    return instance_label, instance_to_class
