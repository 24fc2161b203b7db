"""The collectives of the sharded paths, with their adjoints and counts.

``all_to_all`` (equal blocks along dim 0) and ``all_reduce`` (sum) run
``torch.distributed``'s collectives (NCCL on the card, gloo on the CPU)
and are differentiable: the adjoint of an even all-to-all is the same
exchange, and the adjoint of a sum over ranks is the sum over ranks of
the grads.  (Where every rank computes the same loss, ``assemble`` in
``sharding.py`` splits the grad of a replicated output evenly over its
copies, so the sum counts it once.)
``all_gather`` serves ``sharding.assemble``.  ``calls`` counts every
call, backward ones included, so that a run can show that it reached
the process group.  Under an active dry-run count each call also
reports its op (by the reference's HLO name), result bytes and group
size (``counting.note_collective``), which
``launch.roofline.collective_stats`` prices.  ``group=None`` is the
default (world) group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import counting

calls = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0}
_HLO_NAMES = {"all_to_all": "all-to-all", "all_reduce": "all-reduce",
              "all_gather": "all-gather"}


def reset_counts() -> None:
    for k in calls:
        calls[k] = 0


def _record(name: str, result_bytes: int, group) -> None:
    calls[name] += 1
    if counting.active():
        counting.note_collective({
            "op": _HLO_NAMES[name], "result_bytes": result_bytes,
            "group_size": dist.get_world_size(group)})


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def world_size() -> int:
    """Ranks of the default process group (1 where none is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _record("all_to_all", _nbytes(out), group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    _record("all_reduce", _nbytes(out), group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, d_out):
        return _all_to_all(d_out, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, d_out):
        return _all_reduce(d_out, ctx.group), None


def _takes_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block i of dim 0 goes to rank i of ``group``; block j of the result
    came from rank j."""
    if _takes_grad(x):
        return _AllToAll.apply(x, group)
    return _all_to_all(x, group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, in a new tensor."""
    if _takes_grad(x):
        return _AllReduce.apply(x, group)
    return _all_reduce(x, group)


def all_gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape), by rank; not differentiable."""
    x = x.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    _record("all_gather", len(out) * _nbytes(x), group)
    return out


__all__ = ["calls", "reset_counts", "world_size", "all_to_all", "all_reduce",
           "all_gather"]
