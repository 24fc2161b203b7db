"""Mixture-of-Experts layer (paper Sec. III-C) with placement-aware layout.

Counterpart of ``repro.models.moe``: softmax gate scores (Eq. 11), top-K
selection, combine weights normalized over the active set (Eq. 15), and a
sort+gather dispatch into capacity-padded (E, C, d) buckets that drops the
same token copies the reference drops.  The expert FFN runs through
``kernels.ops.expert_ffn``, i.e. the hand-written ``gmm`` kernel on a CUDA
device.  Shared experts (``n_shared_experts``, always active: the
P_i -> 1 limit of Theorem 1) are one dense SwiGLU of fused width
``d_ff_expert * n_shared_experts`` added to the routed output; the
reference computes it outside any kernel, and so does the port
(``layers.ffn_apply``, ``torch.matmul``).  ``apply_placement`` is the
SpaceMoE placement as a checkpoint transform (permuted expert stacks and
router columns; the shared block stays where it is).

EP slotting (``moe_slotting``) re-lays the expert stack into V virtual
slots so that V divides the EP axis (``moe_ep_slots``): E >= S pads with
dummy experts to the next multiple of S (granite-moe-3b-a800m: 40 -> 48;
the dummies get no tokens); E < S splits each expert's d_ff into
fragments (llama-moe-3.5b: 8 experts x 2 halves = 16 slots), each token
copy goes to every fragment of its expert, and the fragments' outputs
are summed before the top-K weights.  On one device the V buckets run
through ``gmm`` as one stack.

Expert parallelism (``moe_apply_ep``, ``moe_apply_ep_replicated``) runs
on ``torch.distributed`` inside ``sharded_moe``, which takes the rank's
data rows and its blocks of the expert stacks (the rank holds no more)
and gives the body what ``shard_map`` would: along the EP axis, the
rank's block of the tokens (or all of them, replicated) and the rest of
the weights whole; the output is put back together along that axis, and
a per-shard output (``aux``) is the first rank's on every rank.  The
bodies take the reference's arguments and the mesh whose ``axis_name``
they exchange over (a ``shard_map`` body finds it in its context).
Their all-to-all and all-reduce are ``distributed.collectives``'
(differentiable, counted).

Without EP, a mesh runs ``moe_apply_sharded``: the reference's
single-program "local" mode, with its capacity, queue order and router
statistics those of the global batch, and each rank computing its part:
the rank's block of every expert's capacity slots (the slots split over
the data axes) and its block of ``d_ff`` (split over the model axis, as
the rules shard the stacks when the bucket count does not divide it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.collectives import (copy_to, gather_from, reduce_from,
                                      split_to)
from ..distributed.sharding import assemble
from ..kernels import ops
from .config import ModelConfig
from .layers import ffn_apply, ffn_init, normal_init, out_proj_init


# --------------------------------------------------------------------- #
# EP slotting (paper Sec. VI-B multi-expert rule on devices)
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class Slotting:
    n_experts: int
    n_slots: int       # EP axis size the layout targets
    frag: int          # d_ff fragments per expert
    e_pad: int         # padded expert count (>= n_experts)

    @property
    def n_virtual(self) -> int:
        return self.e_pad * self.frag


def make_slotting(n_experts: int, n_slots: int) -> Slotting:
    if n_experts >= n_slots:
        e_pad = -(-n_experts // n_slots) * n_slots
        return Slotting(n_experts, n_slots, 1, e_pad)
    e_pad = n_experts
    while n_slots % e_pad:
        e_pad += 1
    return Slotting(n_experts, n_slots, n_slots // e_pad, e_pad)


def slotting_for(cfg: ModelConfig) -> Slotting | None:
    if not cfg.moe_slotting or cfg.n_experts == 0:
        return None
    return make_slotting(cfg.n_experts, cfg.moe_ep_slots)


def slotted_weights(w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, sl: Slotting):
    """Canonical (E,d,f)/(E,f,d) stacks -> virtual (V,d,f/frag)/(V,f/frag,d),
    slot-major per expert, contiguous; dummy experts are zeros."""
    e, d, f = w_gate.shape
    if f % sl.frag:
        raise ValueError(f"d_ff_expert={f} not divisible by frag={sl.frag}")
    pad = sl.e_pad - e
    if pad:
        w_gate = torch.cat([w_gate, w_gate.new_zeros((pad, d, f))])
        w_up = torch.cat([w_up, w_up.new_zeros((pad, d, f))])
        w_down = torch.cat([w_down, w_down.new_zeros((pad, f, d))])
    fs = f // sl.frag
    # (E', d, f) -> (E', frag, d, fs) -> (V, d, fs)
    wg = w_gate.reshape(sl.e_pad, d, sl.frag, fs).permute(0, 2, 1, 3) \
        .reshape(sl.n_virtual, d, fs)
    wu = w_up.reshape(sl.e_pad, d, sl.frag, fs).permute(0, 2, 1, 3) \
        .reshape(sl.n_virtual, d, fs)
    wd = w_down.reshape(sl.n_virtual, fs, d)
    return wg.contiguous(), wu.contiguous(), wd.contiguous()


def virtual_indices(idx: torch.Tensor, sl: Slotting) -> torch.Tensor:
    """(T, K) expert ids -> (T, K*frag) virtual slot ids."""
    frag_ids = torch.arange(sl.frag, dtype=idx.dtype, device=idx.device)
    v = idx[..., None] * sl.frag + frag_ids          # (T, K, frag)
    return v.reshape(idx.shape[0], -1)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The canonical (E, d, f) stacks, slotted where ``cfg`` asks for it."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {
        "router": normal_init(gen, (d, e), torch.float32, device),  # kept f32
        "w_gate": normal_init(gen, (e, d, f), dtype, device),
        "w_up": normal_init(gen, (e, d, f), dtype, device),
        "w_down": out_proj_init(gen, (e, f, d), dtype, device, cfg.n_layers),
    }
    sl = slotting_for(cfg)
    if sl is not None:
        p["w_gate"], p["w_up"], p["w_down"] = slotted_weights(
            p["w_gate"], p["w_up"], p["w_down"], sl)
    if cfg.n_shared_experts > 0:
        p["shared"] = ffn_init(gen, d, f * cfg.n_shared_experts,
                               cfg.n_layers, dtype, device)
    return p


# --------------------------------------------------------------------- #
# Routing (Eq. 11 + top-K + Eq. 15 combine weights)
# --------------------------------------------------------------------- #


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor,
          data_group=None, n_data: int = 1):
    """x: (T, d) -> (weights (T,K), idx (T,K) int64, aux dict).  With
    ``data_group`` x is one of ``n_data`` equal blocks of the batch, and
    the aux statistics are the whole batch's (sums over the group)."""
    logits = x.float() @ router_w.float()                            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k takes the lower index among equal values; a stable
    # descending sort keeps equal values in index order, so its first K
    # columns are the same choice.
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_i = sorted_p[:, :cfg.top_k], sorted_i[:, :cfg.top_k]
    weights = top_p / top_p.sum(dim=-1, keepdim=True)                # Eq. 15
    # Switch-style load-balance loss + router z-loss.
    e = cfg.n_experts
    # scatter_add of ones (exact in f32), not bincount: bincount on a CUDA
    # tensor waits for the device to size its output.
    flat = top_i.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    z = torch.logsumexp(logits, dim=-1) ** 2
    if data_group is None:
        me, ce, zl = probs.mean(dim=0), counts / top_i.numel(), z.mean()
    else:
        t = x.shape[0] * n_data
        me = reduce_from(probs.sum(dim=0), data_group) / t
        ce = collectives.all_reduce(counts, data_group) / (t * cfg.top_k)
        zl = reduce_from(z.sum(), data_group) / t
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "router_z_loss": zl,
        "expert_counts": ce,
    }
    return weights, top_i, aux


# --------------------------------------------------------------------- #
# Sort + gather dispatch to capacity-padded (E, C, d) buckets
# --------------------------------------------------------------------- #


def capacity(cfg: ModelConfig, n_tokens: int, n_buckets: int) -> int:
    c = int(np.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / n_buckets))
    return max(c, cfg.top_k)


def dispatch_indices(idx: torch.Tensor, n_experts: int, cap: int):
    """Compute the gather plan mapping (E, C) slots to token copies.

    idx: (T, K) expert choice per token copy.  Returns
      slot_token: (E*C,) index into the flattened (T*K,) copy list
                  (0 where unfilled),
      slot_valid: (E*C,) bool — slot actually holds a token,
      copy_slot:  (T*K,) slot of each copy (0 where dropped),
      copy_kept:  (T*K,) bool.
    Copies beyond an expert's capacity are dropped in token order, as in
    the reference.
    """
    tk = idx.numel()
    dev = idx.device
    flat = idx.reshape(-1).long()                              # (T*K,)
    order = torch.argsort(flat, stable=True)                   # sort copies by expert
    sorted_e = flat[order].contiguous()
    # position within expert = rank among same-expert copies
    pos_in_e = torch.arange(tk, device=dev) \
        - torch.searchsorted(sorted_e, sorted_e, side="left")
    kept = pos_in_e < cap
    slot_of_sorted = sorted_e * cap + pos_in_e                 # (T*K,)
    # Dropped copies target a trash slot E*C that is cut off afterwards
    # (the reference's scatter mode="drop"); no valid slot is overwritten.
    n_slots = n_experts * cap
    tgt = torch.where(kept, slot_of_sorted, torch.full_like(slot_of_sorted, n_slots))
    slot_token = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev) \
        .scatter_(0, tgt, order)[:n_slots]
    slot_valid = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev) \
        .scatter_(0, tgt, torch.ones_like(kept))[:n_slots]
    copy_slot = torch.zeros(tk, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.where(kept, slot_of_sorted, torch.zeros_like(slot_of_sorted)))
    copy_kept = torch.zeros(tk, dtype=torch.bool, device=dev).scatter_(0, order, kept)
    return slot_token, slot_valid, copy_slot, copy_kept


class _PairedGather(torch.autograd.Function):
    """``src[index] * valid``, differentiated by the paired gather.

    The dispatch (token -> slot) and combine (slot -> copy) gathers are
    each other's adjoints: every kept copy fills exactly one slot.  So the
    grad of one is the other gather, ``d_out[back_index] * back_valid``,
    summed over the ``group`` consecutive rows that share a source row
    (a token's K * frag copies).  Autograd's own backward of an index
    (an index_put with accumulate) would instead add up every unfilled
    slot and dropped copy, which all point at row 0: at
    granite-moe-3b-a800m's training shapes that was about 16,000 rows
    accumulated one after another, 106 ms a layer on the H100.
    """

    @staticmethod
    def forward(ctx, src, index, valid, back_index, back_valid, group):
        ctx.save_for_backward(back_index, back_valid)
        ctx.group, ctx.rows = group, src.shape[0]
        return src[index] * valid[:, None].to(src.dtype)

    @staticmethod
    def backward(ctx, d_out):
        back_index, back_valid = ctx.saved_tensors
        d_src = d_out[back_index] * back_valid[:, None].to(d_out.dtype)
        if ctx.group > 1:
            d_src = d_src.reshape(ctx.rows, ctx.group, -1).sum(dim=1)
        return d_src, None, None, None, None, None


def _gather(src, index, valid, back_index, back_valid, group: int):
    """``src[index] * valid``: through ``_PairedGather`` when a grad is to
    be taken, else as it is (serve)."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _PairedGather.apply(src, index, valid, back_index, back_valid,
                                   group)
    return src[index] * valid[:, None].to(src.dtype)


def expert_ffn(params: dict, xs: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Batched SwiGLU over expert buckets through the gmm kernel:
    xs (E, C, d) -> (E, C, d)."""
    return ops.expert_ffn(params, xs, compute_dtype)


def _plan(cfg: ModelConfig, idx: torch.Tensor, t: int):
    """Virtual-slot dispatch plan: (v_idx, n_buckets, cap, frag)."""
    sl = slotting_for(cfg)
    if sl is None:
        return idx, cfg.n_experts, capacity(cfg, t, cfg.n_experts), 1
    return (virtual_indices(idx, sl), sl.n_virtual,
            capacity(cfg, t, sl.e_pad), sl.frag)


def _combine(gathered: torch.Tensor, weights: torch.Tensor, t: int, k: int,
             frag: int, compute_dtype) -> torch.Tensor:
    """(T*K*frag, d) copy outputs -> (T, d): sum fragments, weight top-K."""
    per_copy = gathered.reshape(t, k, frag, -1).sum(dim=2)
    return torch.einsum("tkd,tk->td", per_copy, weights.to(compute_dtype))


def _dispatch(cfg, xt, v_idx, n_buckets: int, cap: int, frag: int):
    """(buckets (n_buckets*cap, d), the combine gather's index arguments).

    Copy j of the flattened (T*K*frag,) list is token j // (K*frag): the
    tokens are gathered directly instead of materializing the copies."""
    k = cfg.top_k
    slot_token, slot_valid, copy_slot, copy_kept = dispatch_indices(
        v_idx, n_buckets, cap)
    buckets = _gather(xt, slot_token // (k * frag), slot_valid, copy_slot,
                      copy_kept, k * frag)
    return buckets, (copy_slot, copy_kept, slot_token, slot_valid)


def moe_apply_local(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    compute_dtype) -> tuple[torch.Tensor, dict]:
    """Single-device MoE: x (B, S, d) -> (B, S, d).  With slotting the
    V virtual buckets (E' * frag) run as one stack."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d).to(compute_dtype)
    weights, idx, aux = route(cfg, params["router"], xt)
    v_idx, n_b, cap, frag = _plan(cfg, idx, t)
    buckets, back = _dispatch(cfg, xt, v_idx, n_b, cap, frag)
    outs = expert_ffn(params, buckets.reshape(n_b, cap, d), compute_dtype)
    gathered = _gather(outs.reshape(n_b * cap, d), *back, 1)
    y = _combine(gathered, weights, t, cfg.top_k, frag, compute_dtype)
    if cfg.n_shared_experts > 0:
        y = y + ffn_apply(params["shared"], xt, compute_dtype)
    return y.reshape(b, s, d), aux


def moe_apply_sharded(cfg: ModelConfig, params: dict, x: torch.Tensor,
                      compute_dtype, par) -> tuple[torch.Tensor, dict]:
    """The "local" mode under ``par``'s mesh (module docstring): x is the
    rank's data rows (B_loc, S, d), the expert stacks its blocks of d_ff
    where ``par`` splits them.  Routing is the rank's; the router's
    statistics, the capacity and every expert's queue are the global
    batch's: the rank gathers all ranks' expert choices over the data
    axes and plans the dispatch as one device would, so each rank's copies
    take the slots a single program gives them.  Each rank then computes
    its block of every expert's slots (with every rank's tokens, gathered
    over the data axes) through ``gmm``, the expert outputs are gathered
    back, and the rank combines its own tokens.  Equal to
    ``moe_apply_local`` on the whole batch up to summation order."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    dg = par.data_group() if par.dp else None
    n_d, me = (par.n_data, par.data_rank()) if par.dp else (1, 0)
    xt = x.reshape(t, d).to(compute_dtype)
    weights, idx, aux = route(cfg, params["router"], xt, dg, n_d)
    v_idx, n_b, cap, frag = _plan(cfg, idx, t * n_d)
    kf = k * frag
    if dg is None:
        v_all, x_all = v_idx, xt
    else:       # every rank's choices and tokens, in the batch's row order
        v_all = torch.cat(collectives.all_gather(v_idx, dg))
        x_all = copy_to(gather_from(xt, 0, dg), dg)
    slot_token, slot_valid, copy_slot, copy_kept = dispatch_indices(
        v_all, n_b, cap)
    # The (n_b, cap) slots padded to n_d equal blocks of c_loc; this
    # rank computes block ``me`` of every expert.
    c_loc = -(-cap // n_d)
    pad = c_loc * n_d - cap
    slot_token = torch.cat([slot_token.view(n_b, cap),
                            slot_token.new_zeros((n_b, pad))], dim=1)
    slot_valid = torch.cat([slot_valid.view(n_b, cap),
                            slot_valid.new_zeros((n_b, pad))], dim=1)
    c0 = me * c_loc
    my_tok = slot_token[:, c0:c0 + c_loc].reshape(-1)
    my_valid = slot_valid[:, c0:c0 + c_loc].reshape(-1)
    e_of, c_of = copy_slot // cap, copy_slot % cap
    in_block = copy_kept & (c_of >= c0) & (c_of < c0 + c_loc)
    buckets = _gather(x_all, my_tok // kf, my_valid,
                      torch.where(in_block, e_of * c_loc + c_of - c0,
                                  torch.zeros_like(c_of)), in_block, kf)
    tp = par.split(cfg.d_ff_expert // frag)
    xs = buckets.reshape(n_b, c_loc, d)
    if tp:
        xs = copy_to(xs, par.model_group())
    outs = expert_ffn(params, xs, compute_dtype)
    if tp:
        outs = reduce_from(outs, par.model_group())
    if dg is not None:        # each rank combines its copies from all slots
        outs = copy_to(gather_from(outs, 1, dg), dg)
    # This rank's copies, and for each padded slot the copy it holds.
    lo, n_copies = me * t * kf, t * kf
    mine = copy_slot[lo:lo + n_copies]
    rel = slot_token.reshape(-1) - lo
    held = slot_valid.reshape(-1) & (rel >= 0) & (rel < n_copies)
    gathered = _gather(outs.reshape(-1, d), (mine // cap) * (c_loc * n_d)
                       + mine % cap, copy_kept[lo:lo + n_copies],
                       torch.where(held, rel, torch.zeros_like(rel)), held, 1)
    y = _combine(gathered, weights, t, k, frag, compute_dtype)
    if cfg.n_shared_experts > 0:
        y = y + ffn_apply(params["shared"], xt, compute_dtype, par,
                          cfg.d_ff_expert * cfg.n_shared_experts)
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------- #
# Expert-parallel paths (run inside sharded_moe over the EP axis)
# --------------------------------------------------------------------- #

def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _split_dim(spec, axis: str) -> int | None:
    """The dim ``spec`` splits over ``axis`` (None if it does not)."""
    for i, entry in enumerate(spec):
        if axis == entry or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def sharded_moe(fn, mesh, in_specs, out_specs, axis: str = "model"):
    """``fn`` over this rank's blocks along ``axis``, with ``shard_map``'s
    contract, for a rank that holds its data rows and its blocks of the
    weights (along the other axes it holds its blocks already).

    ``in_specs`` are (the params' specs, the tokens' spec).  A param whose
    spec names ``axis`` is the rank's block and passes as it is; one held
    whole enters through ``copy_to`` (the ranks' bodies differ, so its
    grad is summed over the axis).  The tokens are cut to the rank's
    block of the dim their spec splits over ``axis`` (``split_to``), or
    enter whole through ``copy_to``.  ``out_specs`` are (the output's
    spec, the aux's specs): the output is gathered along the dim its spec
    splits over ``axis`` (else it is the body's, which summed it over
    the axis), and an aux spec that names no axis gives the first rank's
    value on every rank (``sharding.assemble`` over the whole group,
    whose grad is the ranks' mean), which is what the reference's
    ``shard_map(check_vma=False)`` returns for its per-shard ``aux``.
    """
    group = mesh.group(axis)
    p_specs, x_spec = in_specs
    y_spec, aux_spec = out_specs

    def sharded(params, x):
        local = _tree_map(lambda t, sp: t if _split_dim(sp, axis) is not None
                          else copy_to(t, group), params, p_specs)
        d = _split_dim(x_spec, axis)
        x = copy_to(x, group) if d is None else split_to(x, d, group)
        y, aux = fn(local, x)
        d = _split_dim(y_spec, axis)
        if d is not None:
            y = gather_from(y, d, group)
        aux = _tree_map(lambda t, sp: assemble(t, sp, mesh)
                        if not any(e is not None for e in sp) else t,
                        aux, aux_spec)
        return y, aux

    return sharded


def _axis(mesh, axis_name: str):
    """(size, this rank's index, process group) of ``axis_name``."""
    return (mesh.shape[axis_name], mesh.coordinate()[axis_name],
            mesh.group(axis_name))


def moe_apply_ep(cfg: ModelConfig, params: dict, x_local: torch.Tensor,
                 axis_name: str, compute_dtype,
                 mesh) -> tuple[torch.Tensor, dict]:
    """EP MoE body.  ``x_local``: this rank's (B_loc, S_loc, d) slice; the
    expert stacks hold only the local group (E_loc, ...); ``axis_name``
    is the EP axis of ``mesh``.

    Route, bucket by *global* slot, all-to-all (split by owner rank),
    the local expert FFN (``gmm``), reverse all-to-all, combine.
    """
    n_dev, _, group = _axis(mesh, axis_name)
    b, s, d = x_local.shape
    t = b * s
    loc = params["w_gate"].shape[0]          # local buckets (experts/slots)
    xt = x_local.reshape(t, d).to(compute_dtype)
    weights, idx, aux = route(cfg, params["router"], xt)
    v_idx, n_b, cap, frag = _plan(cfg, idx, t)
    if n_b != loc * n_dev:
        raise ValueError(f"bucket count {n_b} != {loc}x{n_dev} local stacks")
    buckets, back = _dispatch(cfg, xt, v_idx, n_b, cap, frag)
    # dest-rank major; after the exchange dim 0 indexes the source rank.
    recv = collectives.all_to_all(buckets.reshape(n_dev, loc, cap, d), group)
    recv = recv.transpose(0, 1).reshape(loc, n_dev * cap, d)
    outs = expert_ffn(params, recv, compute_dtype)            # (loc, n*C, d)
    back_out = outs.reshape(loc, n_dev, cap, d).transpose(0, 1)
    home = collectives.all_to_all(back_out, group)
    gathered = _gather(home.reshape(n_b * cap, d), *back, 1)
    y = _combine(gathered, weights, t, cfg.top_k, frag, compute_dtype)
    if "shared" in params:
        y = y + ffn_apply(params["shared"], xt, compute_dtype)
    return y.reshape(b, s, d), aux


def moe_apply_ep_replicated(cfg: ModelConfig, params: dict,
                            x_local: torch.Tensor, axis_name: str,
                            compute_dtype, mesh) -> tuple[torch.Tensor, dict]:
    """EP for replicated activations (decode).

    Every rank of the EP axis holds the same tokens, routes them all and
    computes only its local expert group; copies bound elsewhere go to a
    trash bucket (local id ``loc``) whose output is zero, and one
    all-reduce of (T, d) combines.  The shared experts run replicated.
    """
    n_dev, my, group = _axis(mesh, axis_name)
    b, s, d = x_local.shape
    t = b * s
    loc = params["w_gate"].shape[0]
    xt = x_local.reshape(t, d).to(compute_dtype)
    weights, idx, aux = route(cfg, params["router"], xt)
    v_idx, n_b, cap, frag = _plan(cfg, idx, t)
    if n_b != loc * n_dev:
        raise ValueError(f"bucket count {n_b} != {loc}x{n_dev} local stacks")
    is_mine = (v_idx // loc) == my
    local_idx = torch.where(is_mine, v_idx - my * loc,
                            torch.full_like(v_idx, loc))
    buckets, back = _dispatch(cfg, xt, local_idx, loc + 1, cap, frag)
    outs = expert_ffn(params, buckets.reshape(loc + 1, cap, d)[:loc],
                      compute_dtype)
    outs = torch.cat([outs, outs.new_zeros((1, cap, d))])   # zero trash bucket
    gathered = _gather(outs.reshape((loc + 1) * cap, d), *back, 1)
    y = _combine(gathered, weights, t, cfg.top_k, frag, compute_dtype)
    y = reduce_from(y, group)
    if "shared" in params:
        y = y + ffn_apply(params["shared"], xt, compute_dtype)  # replicated
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------- #
# SpaceMoE placement as a checkpoint transform
# --------------------------------------------------------------------- #


def apply_placement(moe_params: dict, slot_to_expert: np.ndarray) -> dict:
    """Permute a MoE layer's weights so EP slot s hosts expert
    ``slot_to_expert[s]`` (a ``DevicePlacementPlan.expert_perm``).

    The router columns are permuted identically, so routing semantics are
    unchanged: logits[slot] == original logits[slot_to_expert[slot]].

    A slotted stack (V virtual rows for E experts, V != E) raises: an
    E-long permutation of its rows would keep E of the V rows.  (The
    reference permutes it all the same and fails later, in the expert
    einsum.)
    """
    n_rows, n_experts = (moe_params["w_gate"].shape[0],
                         moe_params["router"].shape[1])
    if n_rows != n_experts:
        raise ValueError(
            f"apply_placement: the expert stack has {n_rows} rows for "
            f"{n_experts} experts (an EP-slotted layout, V != E); the "
            "placement permutes experts, not virtual slots")
    perm = torch.as_tensor(np.asarray(slot_to_expert), dtype=torch.int64,
                           device=moe_params["router"].device)
    out = dict(moe_params)
    out["router"] = moe_params["router"][:, perm]
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = moe_params[name][perm]
    return out


__all__ = ["Slotting", "make_slotting", "slotting_for", "slotted_weights",
           "virtual_indices", "moe_init", "route", "capacity",
           "dispatch_indices", "expert_ffn", "moe_apply_local",
           "moe_apply_sharded", "sharded_moe", "moe_apply_ep", "moe_apply_ep_replicated",
           "apply_placement"]
