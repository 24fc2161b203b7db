"""Step functions and meta-device input stand-ins (counterpart of
``repro.launch.steps``).

The train, prefill and serve steps take ``par`` (``models.Parallel``) as
the reference's do.  Under a mesh they take this rank's blocks of their
inputs (params, optimizer state, batch, cache, tokens; ``pos`` whole) and
compute its part: the train step sums the grads over the data axes, and
the serve step returns the global next tokens and logits on every rank
(the reference's ``out_shardings``), the cache in blocks.  With
``par.zero_opt`` (ZeRO-1, the reference's ``ShardingRules(zero_opt=
True)``) each moment the rules split over the data axes is the rank's
slice of its param's block (``zero_split``): the train step
reduce-scatters that grad over the data axes into the slice, updates the
slice of the param, and all-gathers the updated slices back into the
block, in place.
``input_specs(cfg, shape)`` gives every input of one (arch x shape) cell
as tensors on the ``meta`` device, where the reference gives
``ShapeDtypeStruct``s: shapes and dtypes, no storage; with ``par``, the
rank's blocks of them.  ``param_structs`` draws ``init_params`` on
``meta`` (with a CPU generator: ``torch.Generator`` has no meta device,
and a meta draw reads none of its state), in ``cfg.param_dtype`` as the
reference's structs.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.shapes import ShapeSpec
from ..distributed import collectives
from ..distributed.sharding import (FUSED, _get, _tree_map_with_path,
                                    shard_tree)
from ..models import (Parallel, batch_specs, decode_step, init_cache,
                      init_params, loss_fn, prefill)
from ..models.config import ModelConfig
from ..models.model import gather_logits
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_leaves, tree_map, tree_unflatten


def zero_split(cfg: ModelConfig, par: Parallel):
    """ZeRO-1's cut of each leaf of the rank's params: (dim, parts, fused)
    where the rules split its moments over the data axes (the dim of the
    block, the data ranks; ``fused`` where that dim is a ``FUSED`` leaf's
    last, two halves each cut alike), None elsewhere; None without
    ``par.zero_opt`` or data ranks."""
    if par.mesh is None or not par.zero_opt or par.n_data == 1:
        return None
    structs = param_structs(cfg)
    dims = par.rules(cfg).zero_dims(structs)

    def cut(path, leaf):
        z = _get(dims, path)
        if z is None:
            return None
        return (z, par.n_data, str(path[-1]) in FUSED and z == leaf.dim() - 1)
    return _tree_map_with_path(cut, structs)


def _cut_view(x: torch.Tensor, cut) -> tuple[torch.Tensor, int]:
    """(view of ``x``, dim) whose equal blocks along dim are the ZeRO-1
    slices: ``x`` itself, or a fused leaf's last dim as (2, h)."""
    dim, _, fused = cut
    if fused:
        return x.unflatten(-1, (2, x.shape[-1] // 2)), x.dim()
    return x, dim


def _slice(x: torch.Tensor, cut, rank: int) -> torch.Tensor:
    """This data rank's ZeRO-1 slice of the block ``x``, a view (shaped as
    ``_cut_view``'s)."""
    view, dim = _cut_view(x, cut)
    n = view.shape[dim] // cut[1]
    return view.narrow(dim, rank * n, n)


def _sum_over_data(par: Parallel, grads, split=None):
    """Each rank's grads hold its rows' part of the batch's: their sum
    over the data axes is the grad (the model axis needs none: its ranks'
    backward passes sum there already).  A leaf with a ZeRO-1 cut in
    ``split`` gets only its slice of the sum (a reduce-scatter; its
    slice alone where the rows are not split), in the moments' shape."""
    if not par.dp and split is None:
        return grads
    group = par.data_group() if par.dp else None

    def reduce(g, cut=None):
        if cut is None:
            return collectives.all_reduce_(g, group) if par.dp else g
        if par.dp:
            view, dim = _cut_view(g, cut)
            out = collectives.reduce_scatter(view, dim, group)
        else:
            out = _slice(g, cut, par.data_rank()).contiguous()
        return out.flatten(-2) if cut[2] else out
    return tree_map(reduce, grads, *(() if split is None else (split,)))


def _zero_update(opt_cfg, par: Parallel, params, grads, opt_state,
                 lr_scale, groups, split):
    """``adamw_update`` on the rank's ZeRO-1 slices (the whole block of a
    leaf without a cut), then each updated slice all-gathered over the
    data axes back into its block, in place: (params, opt_state, gnorm)."""
    rank = par.data_rank()
    ps, gs, ms, vs = [], [], [], []
    for p, g, m, v, cut in zip(tree_leaves(params), tree_leaves(grads),
                               tree_leaves(opt_state["mu"]),
                               tree_leaves(opt_state["nu"]),
                               tree_leaves(split, tuple_leaves=True)):
        if cut is not None:
            p = _slice(p, cut, rank)
            g, m, v = (t.view(p.shape) for t in (g, m, v))
        ps.append(p)
        gs.append(g)
        ms.append(m)
        vs.append(v)
    state = {"mu": ms, "nu": vs, "count": opt_state["count"]}
    _, state, gnorm = adamw_update(opt_cfg, ps, gs, state, lr_scale,
                                   tree_leaves(groups, tuple_leaves=True))
    opt_state["count"] = state["count"]
    group = par.data_group()
    for p, cut in zip(tree_leaves(params), tree_leaves(split, tuple_leaves=True)):
        if cut is not None:
            view, dim = _cut_view(p, cut)
            collectives.all_gather_into(view, _slice(p, cut, rank), dim,
                                        group)
    return params, opt_state, gnorm


def _value_and_grad(cfg: ModelConfig, par: Parallel, params, batch,
                    reduce: bool = True):
    """((loss, metrics), grads): grads in each leaf's dtype, zeros for a
    leaf the loss does not reach (as ``jax.value_and_grad``); under a
    mesh, summed over the data axes unless ``reduce`` is off."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch, par)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = tree_unflatten(params, grads)
    return (loss.detach(), metrics), \
        _sum_over_data(par, grads) if reduce else grads


def norm_groups(cfg: ModelConfig, par: Parallel):
    """``global_norm``'s groups for ``par``, per leaf: the model axis's
    group for a block the rules split over it, the data axes' for a
    ZeRO-1 slice of a whole leaf, both (a tuple) for a slice of a block,
    None for a leaf held whole (None without a split)."""
    split = zero_split(cfg, par)
    if par.mesh is None or (par.model_size == 1 and split is None):
        return None
    rules = par.rules(cfg)

    def of(path, leaf):
        spec = rules.param_spec(path, leaf)
        groups = ()
        if par.model_size > 1 and any(
                e == par.model_axis or (isinstance(e, tuple)
                                        and par.model_axis in e)
                for e in spec):
            groups += (par.model_group(),)
        if split is not None and _get(split, path) is not None:
            groups += (par.data_group(),)
        return groups or None
    return _tree_map_with_path(of, param_structs(cfg))


def micro_slices(par: Parallel, batch: dict, micro_batches: int) -> list:
    """The ``micro_batches`` slices of ``batch`` the reference's scan runs.
    Under a split batch, slice m is the rank's block of the global batch's
    slice m: the rank gathers the batch over the data axes and takes those
    rows (its own block's slice m would group other rows)."""
    def check(b):
        if b % micro_batches:
            raise ValueError(
                f"batch {b} not divisible by {micro_batches} slices")
    out = []
    for m in range(micro_batches):
        sl = {}
        for k, v in batch.items():
            if par.dp:
                whole = torch.cat(collectives.all_gather(v, par.data_group()))
                check(whole.shape[0])
                rows = whole.shape[0] // micro_batches
                sl[k] = par.rows(whole.narrow(0, m * rows, rows))
            else:
                check(v.shape[0])
                rows = v.shape[0] // micro_batches
                sl[k] = v.narrow(0, m * rows, rows)
        out.append(sl)
    return out


def make_train_step(cfg: ModelConfig, par: Parallel,
                    opt_cfg: AdamWConfig = AdamWConfig(), schedule=None,
                    micro_batches: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch)`` returns
    (params, opt_state, metrics with loss, ce, aux and grad_norm).

    With ``micro_batches > 1`` the global batch is run as that many
    gradient-accumulation slices (a Python loop where the reference
    scans; ``micro_slices``): f32 grads summed, then divided, losses
    averaged.  Params and opt_state are updated in place
    (``adamw_update``), as the reference's jitted step donates them.
    Under a mesh params and opt_state are the rank's blocks, the batch
    its rows; the grads are summed over the data axes and the grad norm
    counts each block once.  With ``par.zero_opt`` the moments are the
    rank's ZeRO-1 slices (module docstring; ``opt_structs`` and
    ``adamw_init(split=zero_split(cfg, par))`` make them).
    """
    schedule = schedule or (lambda s: 1.0)
    groups = norm_groups(cfg, par)
    split = zero_split(cfg, par)

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = _value_and_grad(cfg, par, params, batch,
                                                     reduce=False)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            ls, ces, auxs = [], [], []
            for sl in micro_slices(par, batch, micro_batches):
                (l, m), g = _value_and_grad(cfg, par, params, sl, reduce=False)
                grads = tree_map(torch.add, grads, g)
                ls.append(l)
                ces.append(m["ce"])
                auxs.append(m["aux"])
                del g        # free this slice's grads before the next's
            grads = tree_map(lambda g: g / micro_batches, grads)
            loss = torch.stack(ls).mean()
            metrics = {"ce": torch.stack(ces).mean(),
                       "aux": torch.stack(auxs).mean()}
        grads = _sum_over_data(par, grads, split)
        lr_scale = schedule(opt_state["count"])
        if split is None:
            params, opt_state, gnorm = adamw_update(
                opt_cfg, params, grads, opt_state, lr_scale, groups)
        else:
            params, opt_state, gnorm = _zero_update(
                opt_cfg, par, params, grads, opt_state, lr_scale, groups,
                split)
        out_metrics = {"loss": loss, "ce": metrics["ce"],
                       "aux": metrics["aux"], "grad_norm": gnorm}
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, par: Parallel, max_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len=max_len, par=par)

    return prefill_step


def make_serve_step(cfg: ModelConfig, par: Parallel):
    """One decode step: greedy next token + logits, cache updated in place.

    ``embeds`` (B, 1, d) feeds the stub audio frontend in place of the
    tokens, as the reference's positional ``embeds`` argument does; pass
    None (the default) for token-input architectures.

    Under a mesh the step takes the rank's blocks (``pos`` whole) and
    returns the global next tokens and logits on every rank; given the
    global tokens (or embeds), as it returns them, it takes its rows.
    """

    def serve_step(params, cache, tokens, pos, embeds=None):
        if par.dp:
            if tokens is not None and tokens.shape[0] == pos.shape[0]:
                tokens = par.rows(tokens)
            if embeds is not None and embeds.shape[0] == pos.shape[0]:
                embeds = par.rows(embeds)
        logits, cache = decode_step(cfg, params, cache, tokens, pos, par=par,
                                    embeds=embeds)
        logits = gather_logits(cfg, logits, par)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


# --------------------------------------------------------------------- #
# Meta-device stand-ins
# --------------------------------------------------------------------- #


def param_structs(cfg: ModelConfig, par: Parallel | None = None) -> dict:
    """``init_params`` on ``meta`` in ``param_dtype``: the global leaves,
    or with ``par`` this rank's blocks."""
    return init_params(cfg, torch.Generator(), "meta", cast=False, par=par)


def opt_structs(params_structs, split=None) -> dict:
    """``adamw_init`` of ``params_structs`` (with ``split``, the rank's
    ZeRO-1 moment slices: ``zero_split``)."""
    return adamw_init(params_structs, split)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int,
                  par: Parallel | None = None) -> dict:
    return init_cache(cfg, batch, max_len, "meta", par)


def _rows(par: Parallel | None, cfg: ModelConfig, tree):
    """The rank's rows of a batch tree (its blocks under ``batch_spec``)."""
    if par is None or par.mesh is None:
        return tree
    rules = par.rules(cfg)
    return shard_tree(tree, rules.batch_spec(tree), par.mesh)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                par: Parallel | None = None) -> dict[str, Any]:
    """All inputs of one (arch x shape) cell, as meta tensors: the global
    ones, or with ``par`` the blocks its rank is given.

    train:   {params, opt_state, batch}
    prefill: {params, batch}            (batch without labels)
    decode:  {params, cache, tokens, pos [, embeds]}   (pos whole)
    """
    p = param_structs(cfg, par)
    if shape.kind == "train":
        return {
            "params": p,
            "opt_state": opt_structs(p, par and zero_split(cfg, par)),
            "batch": _rows(par, cfg, batch_specs(cfg, shape.global_batch,
                                                 shape.seq_len)),
        }
    if shape.kind == "prefill":
        b = batch_specs(cfg, shape.global_batch, shape.seq_len)
        b.pop("labels")
        return {"params": p, "batch": _rows(par, cfg, b)}
    if shape.kind == "decode":
        out = {
            "params": p,
            "cache": cache_structs(cfg, shape.global_batch, shape.seq_len,
                                   par),
            "pos": torch.empty((shape.global_batch,), dtype=torch.int32,
                               device="meta"),
        }
        if cfg.frontend == "audio":
            out["tokens"] = None
            out["embeds"] = _rows(par, cfg, torch.empty(
                (shape.global_batch, 1, cfg.d_model), dtype=torch.bfloat16,
                device="meta"))
        else:
            out["tokens"] = _rows(par, cfg, torch.empty(
                (shape.global_batch, 1), dtype=torch.int32, device="meta"))
        return out
    raise ValueError(shape.kind)
