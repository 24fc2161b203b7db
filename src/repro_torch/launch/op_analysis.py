"""Op-level cost of one eager step (counterpart of
``repro.launch.hlo_analysis``).

The reference walks the compiled HLO.  The port has no HLO: its cost is
the eager program's ops, so ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` and walks those ops instead:

  flops        torch's own formulas (``torch.utils.flop_counter``: the
               matmuls, convolutions and attention ops, as the
               reference counts dots and convolutions)
  bytes        each op's operand bytes plus its result bytes: an eager op
               is one launch that reads its operands and writes its
               result, so this is the unfused traffic the card serves.
               View and metadata ops count nothing (the reference's
               ``_NO_BYTES_OPS``); gathers count their result twice and
               scatters their update twice (its slice rules); ops that
               only write (copies, fills, factories) do not count the
               tensor they overwrite as read
  collectives  the record ``distributed.collectives`` makes of each call
               (``counting.note_collective``), priced by
               ``roofline.collective_stats``; tensor parallelism's
               ``reduce_from``, ``gather_from`` and ``split_to`` (and
               their backward passes) run an all-reduce or an
               all-gather and are counted under those names
  kernels      the hand-written kernels (``gmm``, ``decode_attention``),
               which ctypes launches past the dispatcher: each wrapper
               reports its call through ``counting.kernel(name, flops,
               nbytes)``
               with the arithmetic of its bound in PERF.md, and the ops
               inside (the plain version on the CPU, the output's
               allocation on the card) are not counted

Repeated bodies are counted once per distinct kind of iteration, then
multiplied, as the reference multiplies loop bodies by their trip
counts.  A loop over time or over attention chunks iterates
``counting.steps(n)``: with ``multiply`` on (``analyze``'s default is
off) it runs the first, the second and the last iteration only, the
second one counted n - 2 times, and ``counting.pad`` fills the skipped
iterations' outputs with uncounted copies.  The
autograd nodes an iteration creates are weighted alike (by their
sequence numbers), so the backward of a skipped iteration is counted
too, and so is unit remat's recompute.  The depth of the stack is
multiplied outside the trace: ``by_units`` takes the costs of one and of
two pattern units and extends the difference to the model's depth.
Values computed under ``multiply`` are not the step's values: only
shapes are, and only the counts are meant to be read.

The CUDA kernels count the same on the card, on the CPU (where their
plain versions run) and on ``meta`` tensors (where the wrappers return
empty results of the right shapes), so a step on ``meta`` counts what it
would do on the card, and launches nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import counting

# Ops that move no data: views, allocations, metadata.
_NO_BYTES = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten._unsafe_view",
    "aten._local_scalar_dense", "aten.set_", "aten.resize_",
    "aten.is_same_size", "aten._has_compatible_shallow_copy_type",
    "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset", "aten.record_stream",
})
# Gathers read and write their result (the reference's slice rule).
_GATHERS = frozenset({"aten.index", "aten.index_select", "aten.gather",
                      "aten.embedding", "aten.take"})
# Scatters read and write their update (the last tensor argument).
_SCATTERS = frozenset({
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
    "aten.scatter", "aten.scatter_", "aten.scatter_add", "aten.scatter_add_",
    "aten.index_add", "aten.index_add_", "aten.index_copy",
    "aten.index_copy_", "aten.scatter_reduce", "aten.scatter_reduce_",
})
# Ops that overwrite their first tensor argument (or make a new one)
# without reading it.
_WRITE_ONLY = frozenset({
    "aten.copy_", "aten.fill_", "aten.zero_", "aten.zeros", "aten.ones",
    "aten.full", "aten.zeros_like", "aten.ones_like", "aten.full_like",
    "aten.new_zeros", "aten.new_ones", "aten.new_full", "aten.arange",
    "aten.scalar_tensor",
})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def op_bytes(name: str, func, args, kwargs, out) -> int:
    """Bytes one op reads and writes (module docstring)."""
    if name in _NO_BYTES or func.is_view:
        return 0
    ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if name in _GATHERS:
        return 2 * sum(map(_nbytes, outs))
    if name in _SCATTERS:
        return 2 * _nbytes(ins[-1])
    if name in _WRITE_ONLY:
        ins = ins[1:] if args and isinstance(args[0], torch.Tensor) else ins
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


@dataclasses.dataclass
class OpCost:
    """Rank 0's counted step: the reference's ``HloCost`` fields, and the
    counts by op and by kernel."""
    flops: int = 0
    bytes_accessed: int = 0
    collective_bytes: float = 0.0       # ring cost, per chip
    collective_counts: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)
    kernel_counts: dict = dataclasses.field(default_factory=dict)
    loop_multiplied: bool = True

    def asdict(self):
        return dataclasses.asdict(self)


def _add(d: dict, key, n) -> None:
    d[key] = d.get(key, 0) + n


class _Count(TorchDispatchMode):
    """The dispatch mode of ``analyze``: every op, kernel report and
    collective record, weighted by the loop scopes it runs in."""

    def __init__(self, multiply: bool):
        super().__init__()
        self.multiply = multiply
        self.cost = OpCost(loop_multiplied=multiply)
        self.records: list[dict] = []
        self.paused = 0
        self._scopes: list[list] = []     # [weight] of each open iteration
        self._spans: list[tuple] = []     # (first seq nr, end, weight)
        self._node_weights: dict[int, int] = {}

    # -- weights ------------------------------------------------------- #
    def _node_weight(self, seq: int) -> int:
        """The weight of the iteration whose forward made autograd node
        ``seq`` (the innermost span that holds it), 1 outside loops."""
        w = self._node_weights.get(seq)
        if w is None:
            best = None
            for lo, hi, weight in self._spans:
                if lo <= seq < hi and (best is None or lo > best[0]):
                    best = (lo, weight)
            w = 1 if best is None else best[1]
            self._node_weights[seq] = w
        return w

    def weight(self) -> int:
        """How many ops the one now running stands for: the open
        iterations' weights (forward, and remat's recompute) times the
        weight of the autograd node being run (backward)."""
        w = 1
        node = torch._C._current_autograd_node()
        if node is not None:
            w = self._node_weight(node._sequence_nr())
        for scope in self._scopes:
            w *= scope[0]
        return w

    @contextlib.contextmanager
    def scope(self, weight: int):
        token = [weight]
        outer = 1
        for scope in self._scopes:
            outer *= scope[0]
        self._scopes.append(token)
        start = torch._C._autograd._get_sequence_nr()
        try:
            yield
        finally:
            self._spans.append((start, torch._C._autograd._get_sequence_nr(),
                                outer * weight))
            self._node_weights.clear()
            self._scopes.remove(token)

    # -- counting ------------------------------------------------------ #
    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        w = self.weight()
        _add(self.cost.kernel_counts, name, w)
        self.cost.flops += w * int(flops)
        self.cost.bytes_accessed += w * int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func.namespace != "aten" \
                or func.overloadpacket is torch.ops.aten.lift_fresh:
            return out       # collectives are counted from their records;
        # lift_fresh wraps a Python constant (the CPU's, not meta's)
        from torch.utils.flop_counter import flop_registry
        name = str(func.overloadpacket)
        w = self.weight()
        cost = self.cost
        _add(cost.op_counts, name, w)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            cost.flops += w * int(formula(*args, **kwargs, out_val=out))
        cost.bytes_accessed += w * op_bytes(name, func, args, kwargs, out)
        return out


def analyze(fn, *args, n_devices: int = 1, multiply: bool = False,
            records: list | None = None, **kwargs) -> tuple[OpCost, object]:
    """Run ``fn(*args, **kwargs)`` under a count: (its ``OpCost``, its
    result).  ``n_devices`` is the group size of a collective record
    without one; ``records``, where given, takes the collective records.
    ``multiply`` runs only one iteration of each kind of a ``steps`` loop
    (module docstring): the counts are the step's, its values are not."""
    from .roofline import collective_stats
    count = _Count(multiply)
    with counting.in_force(count), count:
        out = fn(*args, **kwargs)
    if records is not None:
        records += count.records
    stats = collective_stats(count.records, n_devices)
    count.cost.collective_bytes = stats.bytes_per_chip
    count.cost.collective_counts = stats.counts
    return count.cost, out


def by_units(one: OpCost, two: OpCost, n_units: int) -> OpCost:
    """The cost at ``n_units`` pattern units from the costs at one and at
    two: ``one + (n_units - 1) * (two - one)``, field by field."""
    def ext(a, b):
        return a + (n_units - 1) * (b - a)

    def ext_dict(a: dict, b: dict) -> dict:
        out = {k: ext(a.get(k, 0), b.get(k, 0)) for k in {**a, **b}}
        return {k: v for k, v in sorted(out.items()) if v}
    return OpCost(
        flops=ext(one.flops, two.flops),
        bytes_accessed=ext(one.bytes_accessed, two.bytes_accessed),
        collective_bytes=ext(one.collective_bytes, two.collective_bytes),
        collective_counts=ext_dict(one.collective_counts,
                                   two.collective_counts),
        op_counts=ext_dict(one.op_counts, two.op_counts),
        kernel_counts=ext_dict(one.kernel_counts, two.kernel_counts),
        loop_multiplied=one.loop_multiplied and two.loop_multiplied)


__all__ = ["OpCost", "op_bytes", "analyze", "by_units"]
