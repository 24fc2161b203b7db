"""Sharding rules: parameter / cache / batch partition specs per mesh
(counterpart of ``repro.distributed.sharding``).

Megatron-style tensor parallelism over the ``model`` axis (attention heads,
FFN hidden, vocab), expert parallelism over the same axis when the expert
count divides it (otherwise experts fall back to TP over d_ff), batch over
``("pod", "data")``.  Every rule is divisibility-guarded: a dimension that
does not divide the axis is replicated instead of erroring, and the
decision is recorded.

The port's trees have no stacked unit axis: a leaf's path is
``layers/j/...`` for layer j (block ``j % len(pattern)`` of its unit) or
``first/...``, and its spec is the reference's for
``units/b{j % len(pattern)}/...`` without the leading ``None``.

``PartitionSpec`` is a tuple with the reference's ``str``.
``placements`` turns a spec into DTensor placements per mesh axis.

A rank holds and computes only its blocks: ``rank_block`` takes this
rank's block of one leaf and ``shard_tree`` of every leaf of a tree,
the blocks that ``jit``'s ``in_shardings`` would hand a device; the
models then run on them (``models.Parallel``).  A leaf whose spec splits
a fused dimension is taken in the layout its consumer reads: Mamba's
``w_in`` (d, 2 di) is the x half and the z half side by side, and a rank
holds its block of each (``FUSED``).  ``unshard_tree`` puts the global
tree together again on every rank (the tests' yardstick), and
``whole_leaf`` one leaf from the blocks of the ranks that hold its parts
(the sharded checkpoints').  A batch-1 KV cache's sequence is split
over the data axes where it divides them (``cache_spec``: context
parallelism, ``models.Parallel.context``), and with ``zero_opt``
(ZeRO-1) each AdamW moment is its param's block further split over the
data axes along ``zero_dims``' dim (``opt_state_specs``).

``assemble`` puts a global tensor together from every rank's block;
``sharded_moe`` takes it for the EP bodies' per-shard ``aux`` (the first
rank's value on every rank).  It is an autograd function with
``shard_map``'s transpose as its backward: each rank gets its block of
the grad divided by the ranks along the mesh axes the spec leaves out
(the ranks whose blocks are taken as copies of one value).  On values
that are copies that is the gradient of the value; on values that are
not (the reference's per-shard ``aux`` under ``P()``, of which the first
rank's is kept) it is the mean of the ranks' gradients, as ``jax.grad``
through the reference's ``shard_map(check_vma=False)`` gives.
"""
from __future__ import annotations

import itertools
import math
from typing import TYPE_CHECKING

import torch

from . import collectives

if TYPE_CHECKING:     # the models package imports this module
    from ..models.config import ModelConfig


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None (replicated), an axis name, or a
    tuple of axis names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


def _shard(dim: int, axis: str, size: int) -> str | None:
    return axis if (size > 1 and dim % size == 0) else None


def _tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; None stays None."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


class ShardingRules:
    """Builds PartitionSpec trees for a (cfg, mesh) pair."""

    def __init__(self, cfg: ModelConfig, mesh, model_axis: str = "model",
                 data_axes: tuple[str, ...] = ("data",),
                 zero_opt: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axes = data_axes
        self.n_model = mesh.shape[model_axis] if mesh is not None else 1
        self.zero_opt = zero_opt      # ZeRO-1: moments sharded over data too
        self.decisions: dict[str, str] = {}

    # ----------------------------------------------------------------- #
    def _m(self, dim: int) -> str | None:
        return _shard(dim, self.model_axis, self.n_model)

    @property
    def batch_axes(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def n_data(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    def _b(self, dim: int):
        """Batch axes if the dim divides them, else replicate."""
        return self.batch_axes if (self.n_data > 1 and dim % self.n_data == 0) \
            else None

    def _record(self, path: str, spec: P) -> P:
        self.decisions[path] = str(spec)
        return spec

    # ----------------------------------------------------------------- #
    def _mixer_of(self, names: list) -> str:
        """Which mixer family owns this param (its layer's pattern slot)."""
        pattern = self.cfg.pattern
        if names[0] == "first":
            return pattern[0].mixer
        if names[0] == "layers":
            return pattern[int(names[1]) % len(pattern)].mixer
        return "attn"

    def param_spec(self, path: tuple, leaf) -> P:
        names = [str(k) for k in path]
        name = names[-1]
        shape = leaf.shape

        def out(*spec):
            return self._record("/".join(names), P(*spec))

        # ---- embeddings / head ----
        if name == "embed":
            return out(self._m(shape[0]), None)
        if name == "head":
            return out(None, self._m(shape[1]))

        # ---- MoE expert stacks: (E, d, f) / (E, f, d) ----
        if "ffn" in names and name in ("w_gate", "w_up", "w_down") \
                and len(shape) == 3:
            e = shape[0]
            if self.n_model > 1 and e % self.n_model == 0:
                return out(self.model_axis, None, None)      # EP
            # TP inside experts: shard the d_ff dimension
            ff_axis = 2 if name in ("w_gate", "w_up") else 1
            spec = [None, None, None]
            spec[ff_axis] = self._m(shape[ff_axis])
            return out(*spec)
        if name == "router":
            return out(None, None)

        # ---- dense FFN (+ shared experts) ----
        if name in ("w_gate", "w_up") and len(shape) == 2:
            return out(None, self._m(shape[1]))
        if name == "w_down" and len(shape) == 2:
            return out(self._m(shape[0]), None)

        # ---- attention ----
        if name in ("w_q", "w_k", "w_v"):
            return out(None, self._m(shape[1]))
        if name in ("b_q", "b_k", "b_v"):
            return out(self._m(shape[0]))
        if name == "w_o":
            return out(self._m(shape[0]), None)

        # ---- mamba ----
        if name == "w_in":
            return out(None, self._m(shape[1]))
        if name in ("conv_w",):
            return out(None, self._m(shape[1]))
        if name in ("conv_b", "d_skip", "dt_bias"):
            return out(self._m(shape[0]))
        if name in ("w_x_proj",):
            return out(self._m(shape[0]), None)
        if name == "w_dt":
            return out(None, self._m(shape[1]))
        if name == "a_log":
            return out(self._m(shape[0]), None)

        # ---- xLSTM ----
        # mLSTM: q/k/v/z column-sharded (head-dim); sLSTM: tiny state,
        # block-diagonal recurrence -> data-parallel only (the reference's
        # reasons, repro/distributed/sharding.py).
        if name in ("b_gates", "w_gates", "r_h"):
            return out(*([None] * len(shape)))
        if name in ("w_q_m", "w_k_m", "w_v_m"):
            return out(None, self._m(shape[1]))
        if name == "w_x":                        # slstm input projection
            return out(None, None)
        if name == "w_z":
            return out(None, self._m(shape[1]))
        if name == "w_out":
            if self._mixer_of(names) == "slstm":
                return out(None, None)
            return out(self._m(shape[0]), None)

        # norms, gates, biases, scalars -> replicated
        return out(*([None] * len(shape)))

    def param_specs(self, params) -> object:
        return _tree_map_with_path(self.param_spec, params)

    # ----------------------------------------------------------------- #
    def cache_spec(self, path: tuple, leaf) -> P:
        name = str(path[-1])
        shape = leaf.shape
        b = self._b(shape[0])
        if name in ("k", "v"):          # (B, S, Hkv, hd)
            # batch=1 (long-context): context parallelism — shard the cache
            # sequence dim over the batch axes instead.
            s_axis = None
            if b is None and shape[1] % max(self.n_data, 1) == 0:
                s_axis = self.batch_axes
            return P(b, s_axis, self._m(shape[2]), None)
        if name == "ssm":               # (B, di, N)
            return P(b, self._m(shape[1]), None)
        if name == "conv":              # (B, dc-1, di)
            return P(b, None, self._m(shape[2]))
        if name in ("c", "n", "h", "m") and len(shape) >= 2:
            return P(b, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    def cache_specs(self, cache) -> object:
        return _tree_map_with_path(self.cache_spec, cache)

    # ----------------------------------------------------------------- #
    def batch_spec(self, batch) -> object:
        def spec(path, leaf):
            return P(self._b(leaf.shape[0]), *([None] * (leaf.dim() - 1)))

        return _tree_map_with_path(spec, batch)

    def opt_state_specs(self, opt_state, params_specs) -> object:
        """Moments mirror params; step counter replicated.

        With ``zero_opt`` (ZeRO-1), each moment additionally shards its
        largest unsharded divisible dim over the data axes, cutting
        optimizer memory by |data axes|.
        """
        if not self.zero_opt:
            return {"mu": params_specs, "nu": params_specs, "count": P()}

        def zero(path, leaf) -> P:
            spec = _get(params_specs, path)
            entries = list(spec) + [None] * (leaf.dim() - len(spec))
            best, best_dim = -1, 0
            for i, (e, dim) in enumerate(zip(entries, leaf.shape)):
                if e is None and dim % max(self.n_data, 1) == 0 \
                        and dim > best_dim and self.n_data > 1:
                    best, best_dim = i, dim
            if best >= 0:
                entries[best] = self.batch_axes
            return P(*entries)

        mu_specs = _tree_map_with_path(zero, opt_state["mu"])
        return {"mu": mu_specs, "nu": mu_specs, "count": P()}

    def zero_dims(self, params) -> object:
        """Per leaf of ``params`` (global leaves, or their structs), the
        dim along which ZeRO-1 splits its moments over the data axes
        (the entry ``opt_state_specs`` adds to the param's spec); None
        where it adds none, and everywhere without ``zero_opt``."""
        p_specs = self.param_specs(params)
        o_specs = self.opt_state_specs({"mu": params}, p_specs)["mu"]

        def dim(path, leaf):
            added = [i for i, (o, p) in enumerate(zip(
                _get(o_specs, path), list(_get(p_specs, path))
                + [None] * leaf.dim())) if o is not None and p is None]
            return added[0] if added else None
        return _tree_map_with_path(dim, params)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------- #
# Specs on a live mesh: placements, this rank's block, the assembled whole
# --------------------------------------------------------------------- #


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` for the tensor dim it splits, else ``Replicate()``.  (A
    dim split over several axes lists them major first; DTensor reads
    their order from the mesh, so specs that list axes out of the mesh's
    order have no placement and raise.)"""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    order = []
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[a] = Shard(d)
            order.append(a)
    if order != [a for a in mesh.axis_names if a in order]:
        raise ValueError(f"{spec}: axes out of the mesh's order "
                         f"{mesh.axis_names}")
    return tuple(out[a] for a in mesh.axis_names)


def _block_index(entry, coord: dict, shape: dict) -> tuple[int, int]:
    """(index, count) of a dim's block under ``entry``: row-major over the
    entry's axes."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx, n = idx * shape[a] + coord[a], n * shape[a]
    return idx, n


def _block(x: torch.Tensor, spec: P, coord: dict, shape: dict) -> torch.Tensor:
    for d, entry in enumerate(spec):
        i, n = _block_index(entry, coord, shape)
        if n > 1:
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size)
    return x


def _world_mesh(mesh) -> None:
    if mesh.size != collectives.world_size():
        raise ValueError(f"a mesh of {mesh.size} ranks in a process group "
                         f"of {collectives.world_size()}: the blocks are "
                         "exchanged over the whole group")


# Leaves whose last dimension is two fused halves (Mamba's x and z
# columns of ``w_in``): a split of it gives a rank its block of each half,
# side by side (a split of another dimension is plain).
FUSED = ("w_in",)


def rank_block(x: torch.Tensor, spec: P, mesh, fused: bool = False,
               coord: dict | None = None) -> torch.Tensor:
    """The block of ``x`` under ``spec`` that the rank at ``coord`` (this
    rank by default) holds, as a new contiguous tensor (so that ``x`` can
    be freed), or ``x`` itself where ``spec`` splits nothing.  With
    ``fused`` the last dimension is two halves, each split alike."""
    coord = mesh.coordinate() if coord is None else coord
    if all(_block_index(e, coord, mesh.shape)[1] == 1 for e in spec):
        return x
    if fused:
        halves = torch.chunk(x, 2, dim=-1)
        return torch.cat([_block(h, spec, coord, mesh.shape) for h in halves],
                         dim=-1)
    return _block(x, spec, coord, mesh.shape).clone(
        memory_format=torch.contiguous_format)


def _leaf_name(path) -> str:
    return str(path[-1]) if path else ""


def shard_tree(tree, specs, mesh):
    """This rank's block of every leaf of ``tree`` (``rank_block``), in a
    tree of the same structure."""
    def block(path, leaf):
        return rank_block(leaf, _get(specs, path), mesh,
                          _leaf_name(path) in FUSED)
    return _tree_map_with_path(block, tree)


def unshard_tree(tree, specs, mesh):
    """The global tree whose blocks under ``specs`` the ranks hold (the
    inverse of ``shard_tree``), on every rank: every leaf gathered over
    the whole group, no grad.  Along an axis a spec leaves out, the block
    of index 0 is kept."""
    def whole(path, leaf):
        spec = _get(specs, path)
        if collectives.world_size() == 1 or not any(map(_axes, spec)):
            return leaf
        _world_mesh(mesh)
        leaf = leaf.detach()
        if _leaf_name(path) in FUSED:
            return torch.cat([_assemble_blocks(h.contiguous(), spec, mesh)
                              for h in torch.chunk(leaf, 2, dim=-1)], dim=-1)
        return _assemble_blocks(leaf, spec, mesh)
    return _tree_map_with_path(whole, tree)


def whole_leaf(block: torch.Tensor, spec: P, mesh,
               fused: bool = False) -> torch.Tensor:
    """The global tensor of which ``block`` is this rank's block under
    ``spec`` (the inverse of ``rank_block``), on every rank, no grad:
    gathered one split dimension at a time over the ranks of the axes
    that split it, so that at most the block and two copies of the
    leaf are held at once.  ``block`` itself where ``spec`` splits
    nothing."""
    x = block.detach()
    if fused:                              # (..., 2 h) as (..., 2, h)
        x = x.unflatten(-1, (2, x.shape[-1] // 2))
    last = block.dim() - 1
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if n == 1:
            continue
        at = d + 1 if fused and d == last else d
        shape = list(x.shape)
        shape[at] *= n
        x = collectives.all_gather_into(x.new_empty(shape), x, at,
                                        mesh.group_over(axes))
    return x.flatten(-2) if fused else x


def _left_out(spec: P, mesh) -> list[str]:
    """The mesh axes ``spec`` does not name."""
    named = {a for e in spec for a in _axes(e)}
    return [a for a in mesh.axis_names if a not in named]


def _kept(coord: dict, spec: P, mesh) -> bool:
    """Whether this rank's block is the one kept: index 0 along every mesh
    axis ``spec`` does not name."""
    return all(coord[a] == 0 for a in _left_out(spec, mesh))


def _assemble_blocks(block, spec: P, mesh) -> torch.Tensor:
    blocks = collectives.all_gather(block)
    out = block.new_empty([n * math.prod(mesh.shape[a] for a in _axes(e))
                           for n, e in zip(block.shape, spec)]
                          + list(block.shape[len(spec):]))
    grid = mesh.device_mesh.mesh
    for idx in itertools.product(*map(range, grid.shape)):
        coord = dict(zip(mesh.axis_names, idx))
        if _kept(coord, spec, mesh):
            _block(out, spec, coord, mesh.shape).copy_(blocks[int(grid[idx])])
    return out


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _assemble_blocks(block, spec, mesh)

    @staticmethod
    def backward(ctx, d_out):
        coord = ctx.mesh.coordinate()
        d_block = _block(d_out, ctx.spec, coord, ctx.mesh.shape)
        copies = math.prod(ctx.mesh.shape[a] for a in _left_out(
            ctx.spec, ctx.mesh))
        return (d_block / copies).contiguous(), None, None


def assemble(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The global tensor whose blocks under ``spec`` the ranks hold
    (the inverse of :func:`rank_block`), on every rank.  Along a mesh
    axis that ``spec`` does not name, the ranks' blocks are taken as
    copies of one value and the block of index 0 is kept: for ``P()``
    the first rank's value, broadcast to all.  One rank: ``block`` as it
    is."""
    if collectives.world_size() == 1:
        return block
    _world_mesh(mesh)
    if torch.is_grad_enabled() and block.requires_grad:
        return _Assemble.apply(block, spec, mesh)
    return _assemble_blocks(block, spec, mesh)


__all__ = ["PartitionSpec", "ShardingRules", "placements", "FUSED",
           "rank_block", "shard_tree", "unshard_tree", "whole_leaf",
           "assemble"]
