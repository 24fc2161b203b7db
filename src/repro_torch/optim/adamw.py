"""AdamW on the port's parameter trees (counterpart of
``repro.optim.adamw``), operation for operation.

Moments mirror the parameter tree (nested dicts and the per-layer list)
in f32; ``count`` is an int32 step counter.  One step clips the grads by
their global norm (``+1e-9``), updates both moments, applies the bias
corrections from ``count`` and a weight decay decoupled from the
gradient on every leaf, and casts the result back to each leaf's dtype,
as the reference does.  ``torch.optim.AdamW`` is not a substitute: it
rounds differently and folds the decay into the parameter first.

``adamw_update`` writes the new parameters and moments into the tensors
it is given (under ``torch.no_grad``) and returns them: the reference's
jitted train step donates both buffers, and a functional update would
hold a second copy of the parameters and moments (33 GB more for
granite-moe-3b-a800m).  Leaf by leaf, each operation rounds as the
reference's does; only the storage is reused.

ZeRO-1 (``launch.steps``): a moment may be this rank's slice of its
param's block (``adamw_init(split=)``), and the update then runs on the
matching slice of the param and the grad.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed import collectives
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                # peak; multiplied by schedule(step)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, split=None) -> dict:
    """f32 zero moments shaped as ``params`` and a zero int32 count.

    ``split`` (a tree of ``params``' structure, or None): for a leaf
    whose moments are ZeRO-1's slices, (dim, parts): its moments are the
    param's shape with ``dim`` divided by ``parts``; None for the others.
    """
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p, cut=None):
        shape = list(p.shape)
        if cut is not None:
            shape[cut[0]] //= cut[1]
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    rest = () if split is None else (split,)
    return {"mu": tree_map(zeros, params, *rest),
            "nu": tree_map(zeros, params, *rest),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, groups=None) -> torch.Tensor:
    """sqrt of the sum, over leaves, of each leaf's f32 sum of squares.

    ``groups`` (a tree of ``tree``'s structure, or None): for a leaf that
    is this rank's block of a tensor split over a process group, that
    group, or a tuple of groups for a block split over several (a ZeRO-1
    slice of a block split over the model axis), and None for a leaf
    every rank holds whole.  Each split leaf's sum is then summed over
    its groups, so each block counts once and each whole leaf once."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if groups is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    whole, split = [], {}
    for sq, group in zip(leaves, tree_leaves(groups, tuple_leaves=True)):
        if group is not None and not isinstance(group, tuple):
            group = (group,)
        if group is None:
            whole.append(sq)
        else:
            key = tuple(map(id, group))
            split.setdefault(key, (group, []))[1].append(sq)
    total = torch.sum(torch.stack(whole)) if whole else leaves[0] * 0
    for group, sqs in split.values():
        part = torch.sum(torch.stack(sqs))
        for g in group:
            part = collectives.all_reduce(part, g)
        total = total + part
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale,
                 groups=None):
    """One AdamW step, in place (module docstring): returns
    (params, state, gnorm).  ``lr_scale``: the schedule's value at this
    step (a float or a 0-d f32 tensor); ``groups``: as ``global_norm``'s,
    for a rank that holds blocks."""
    with torch.no_grad():
        count = state["count"] + 1
        gnorm = global_norm(grads, groups)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        countf = count.float()
        c1 = 1 - torch.pow(cfg.b1, countf)
        c2 = 1 - torch.pow(cfg.b2, countf)
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                      device=countf.device)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            g = g.float() * clip
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            step = step + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
        state["count"] = count
    return params, state, gnorm
