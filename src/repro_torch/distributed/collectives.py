"""The collectives of the sharded paths, with their adjoints and counts.

``all_to_all`` (equal blocks along dim 0) and ``all_reduce`` (sum) run
``torch.distributed``'s collectives (NCCL on the card, gloo on the CPU)
and are differentiable: the adjoint of an even all-to-all is the same
exchange, and the adjoint of a sum over ranks is the sum over ranks of
the grads.  (Where every rank computes the same loss, ``assemble`` in
``sharding.py`` splits the grad of a replicated output evenly over its
copies, so the sum counts it once.)
``all_gather`` serves ``sharding.assemble``.  ``reduce_scatter`` (this
rank's block along a dim of the sum over the group) and
``all_gather_into`` (the ranks' blocks along a dim, written into a
tensor the caller owns) serve ZeRO-1's grads and updated params and the
sharded checkpoints; neither is differentiated.

Tensor parallelism (Megatron's conjugate pair) takes the loss that the
ranks of a group compute alike as one loss, so that each rank's
backward gives the whole grad of what the group holds in copies:
``copy_to`` is the identity whose backward sums the grads over the group
(the input of a column-parallel product, whose ranks compute different
columns), ``reduce_from`` the sum whose backward is the identity (the
output of a row-parallel product), ``gather_from`` the concatenation of
the ranks' blocks along a dim whose backward takes this rank's block of
the grad, and ``split_to`` its inverse (this rank's block, backward
gathered).  ``all_max`` is an undifferentiated max over the group.  All
run the same three collectives, and count and report under their
names.  ``calls`` counts every
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

calls = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0,
         "reduce_scatter": 0}
_HLO_NAMES = {"all_to_all": "all-to-all", "all_reduce": "all-reduce",
              "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}


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


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _record("all_reduce", _nbytes(out), group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in group-rank order."""
    return torch.cat(_all_gather(x, group), dim=dim)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    _record("all_gather", len(out) * _nbytes(x), group)
    return out


def _my_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


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


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, d_out):
        return _all_reduce(d_out, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, d_out):
        return d_out, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, d_out):
        return _my_block(d_out, ctx.dim, ctx.group), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _my_block(x, dim, group)

    @staticmethod
    def backward(ctx, d_out):
        return _gather(d_out, ctx.dim, ctx.group), None, None


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
    return _all_gather(x.detach(), group)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place (no grad): for
    tensors the caller owns, such as grads, where a new tensor would hold
    a second copy until the first is freed."""
    with torch.no_grad():
        dist.all_reduce(x, group=group)
    _record("all_reduce", _nbytes(x), group)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` (equal blocks, in group-rank
    order) of the sum of ``x`` over ``group``, contiguous (no grad)."""
    n = dist.get_world_size(group)
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    _record("reduce_scatter", _nbytes(out), group)
    return out.movedim(0, dim).contiguous()


def all_gather_into(dst: torch.Tensor, x: torch.Tensor, dim: int,
                    group) -> torch.Tensor:
    """Write the ranks' ``x`` (same shape), concatenated along ``dim`` in
    group-rank order, into ``dst`` (any strides; no grad); returns
    ``dst``."""
    src = x.detach().movedim(dim, 0).contiguous()
    buf = src.new_empty((dist.get_world_size(group) * src.shape[0],
                         *src.shape[1:]))
    dist.all_gather_into_tensor(buf, src, group=group)
    _record("all_gather", _nbytes(buf), group)
    with torch.no_grad():
        dst.copy_(buf.movedim(0, dim))
    return dst


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; its grad is summed over ``group`` (Megatron's f)."""
    if _takes_grad(x):
        return _CopyTo.apply(x, group)
    return x


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its grad passes as it is
    (Megatron's g)."""
    if _takes_grad(x):
        return _ReduceFrom.apply(x, group)
    return _all_reduce(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``; the
    grad of this rank's block is its block of the grad."""
    if _takes_grad(x):
        return _GatherFrom.apply(x, dim, group)
    return _gather(x, dim, group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (equal blocks, in
    group-rank order), contiguous; its grad is gathered."""
    if _takes_grad(x):
        return _SplitTo.apply(x, dim, group)
    return _my_block(x, dim, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (no grad)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


__all__ = ["calls", "reset_counts", "world_size", "all_to_all", "all_reduce",
           "all_reduce_", "all_gather", "reduce_scatter", "all_gather_into",
           "copy_to", "reduce_from", "gather_from", "split_to", "all_max"]
