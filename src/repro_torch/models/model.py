"""Composable LM: init / forward / loss / prefill / decode_step.

Counterpart of ``repro.models.model``: attention, Mamba, mLSTM and sLSTM
mixers with dense, MoE or no FFN.  The reference scans over stacked
pattern units; here the parameters are a list of per-layer dicts
(``params["layers"][i]`` is block ``i % len(pattern)`` of unit
``i // len(pattern)``) and the stack is a Python loop.  With
``first_layer_dense`` the first unit is one dense block of width
``first_dense_d_ff`` (``params["first"]``), run ahead of the
``n_scan_units`` units, as in the reference.  The decode cache is a
matching list of per-layer caches (and ``cache["first"]``): a KV cache
for attention, updated in place, and the recurrent state dict for the
other mixers, which each step replaces in the list.

Dtypes: weights are initialised in ``cfg.param_dtype`` as in the
reference, which casts each weight to ``cfg.compute_dtype`` at every use.
``cast_for_compute`` makes that cast once, at load: the values are
identical, and a decode step then reads each weight once in the compute
dtype instead of re-reading and re-casting the f32 copy.  The leaves the
reference uses in f32 stay f32 (``F32_LEAVES``: the router, the norm
scales and the recurrent mixers' f32 parameters).
``init_params`` makes that cast as each block is drawn, so the draw
peaks at the cast model plus one block in ``param_dtype`` (deepseek-moe-16b
in bf16: 32.26 GiB, against about 61 GiB for the whole model in f32).

Inputs are a batch dict as in the reference: "tokens" (B, S_t) and/or
"embeds" (B, S_e, d) from a stub frontend (``frontends.py``), embeddings
first; ``decode_step`` takes ``embeds`` (B, 1, d) in place of tokens.

Training: ``loss_fn`` is the reference's next-token cross-entropy plus
the MoE aux loss.  With ``cfg.remat == "unit"`` and a grad to take,
``forward`` runs each pattern unit under non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` around
its scan body): a unit's activations are recomputed in the backward, and
the recompute routes the same copies to the same experts (``route``
sorts stably; ``gmm`` sums K in a fixed order).  Training draws the
uncast model (``init_params(cast=False)``): f32 master weights, cast to
the compute dtype at each use, as the reference trains.

Parallelism: ``Parallel`` names a mesh (``launch.mesh``) and picks the
MoE mode as the reference's does.  Under a mesh every function here takes
this rank's blocks, the ones ``jit``'s ``in_shardings`` would hand a
device in the reference's sharded step: the params by
``ShardingRules.param_specs`` (``init_params(par=...)`` draws them leaf
by leaf), the cache by ``cache_specs`` (``init_cache(par=...)``), the
batch, tokens and embeds by ``batch_spec``; ``pos`` whole.  Each rank
computes its part: Megatron tensor parallelism over the model axis
(``layers``, ``attention``, ``ssm``), its rows of the batch over the data
axes, the MoE blocks through the EP bodies (``moe.sharded_moe``) or the
"local" mode over the mesh (``moe.moe_apply_sharded``).  A batch that
does not divide the data axes is whole on every data rank; its KV
cache's sequence is then split over them where it divides them
(``Parallel.context``: context parallelism), and attention combines the
ranks' softmax partials (``attention.attention_decode``).  The values are
the reference's single-program values: the cross-entropy's log-sum-exp
is taken over the vocab's blocks and its mean over the global batch,
and the "local" mode's router statistics, capacity and queues are the
global batch's; the EP bodies keep their per-shard semantics (the first
shard's ``aux``).  The logits come back as the rank's block
(``gather_logits`` puts them together).  Without a mesh nothing changes.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..tree import tree_leaves
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .config import LayerSpec, ModelConfig
from .layers import (dtype_of, embed, embedding_init, ffn_apply, ffn_init,
                     lm_head, normal_init, rmsnorm, rmsnorm_init)
from ..distributed import collectives
from ..distributed.sharding import PartitionSpec as P
from ..distributed.sharding import (FUSED, ShardingRules, rank_block,
                                    shard_tree)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """How a step function should distribute work (None => single shard).

    Under a mesh every tensor a step is given is this rank's block
    (module docstring); ``batch_split`` says whether the batch is split
    over the data axes (False where it does not divide them, as the
    rules then keep it whole: every data rank computes the same rows),
    ``context`` whether the KV cache's sequence is (set it where the
    batch is whole and the cache length divides the data axes, exactly
    where ``ShardingRules.cache_spec`` splits it), and ``zero_opt``
    whether the optimizer state is ZeRO-1's (``rules`` passes it on).
    """

    mesh: object | None = None               # a launch.mesh.Mesh
    data_axes: tuple[str, ...] = ("data",)   # batch axes ("pod","data") multi-pod
    model_axis: str = "model"
    moe_mode: str = "auto"    # "auto" | "ep" | "ep_rep" | "local"
    batch_split: bool = True
    # The KV cache's sequence split over the data axes (context
    # parallelism: a whole batch, a cache length that divides them).
    context: bool = False
    # ZeRO-1: each AdamW moment further split over the data axes.
    zero_opt: bool = False

    def __post_init__(self):
        if self.context and self.batch_split:
            raise ValueError("context parallelism splits the cache's "
                             "sequence over the data axes: the batch must "
                             "be whole there (batch_split=False)")

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def n_data(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.data_axes)

    @property
    def dp(self) -> bool:
        """Whether the ranks along the data axes hold different rows."""
        return self.batch_split and self.n_data > 1

    def split(self, dim: int) -> bool:
        """Whether the rules split a dimension of global size ``dim`` over
        the model axis (it divides an axis of more than one rank)."""
        return self.model_size > 1 and dim % self.model_size == 0

    def model_group(self):
        return self.mesh.group(self.model_axis)

    def model_rank(self) -> int:
        return self.mesh.coordinate()[self.model_axis] if self.mesh else 0

    def data_group(self):
        return self.mesh.group_over(self.data_axes)

    def data_rank(self) -> int:
        """This rank's index along the data axes, row-major."""
        if self.mesh is None:
            return 0
        coord, idx = self.mesh.coordinate(), 0
        for a in self.data_axes:
            idx = idx * self.mesh.shape[a] + coord[a]
        return idx

    @property
    def cp(self) -> bool:
        """Whether the cache's sequence is split over more than one data
        rank (context parallelism)."""
        return self.context and self.n_data > 1

    def rules(self, cfg: ModelConfig):
        return ShardingRules(cfg, self.mesh, self.model_axis, self.data_axes,
                             zero_opt=self.zero_opt)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of rows of ``x`` (whole without ``dp``)."""
        if not self.dp:
            return x
        n = x.shape[0] // self.n_data
        return x.narrow(0, self.data_rank() * n, n)

    def resolve_moe(self, cfg: ModelConfig, seq_len: int) -> str:
        if self.mesh is None or self.model_size == 1:
            return "local"
        if self.moe_mode != "auto":
            return self.moe_mode
        n_buckets = cfg.n_experts
        sl = moe_mod.slotting_for(cfg)
        if sl is not None:
            n_buckets = sl.n_virtual
        if n_buckets % self.model_size == 0:
            if seq_len % self.model_size == 0:
                return "ep"        # sequence-sharded all-to-all dispatch
            return "ep_rep"        # replicated-token EP (decode)
        return "local"             # TP over d_ff via weight sharding

# Parameters the reference keeps and uses in f32 whatever the dtypes: the
# router, the norm scales, Mamba's decay and dt bias, mLSTM's gates and
# sLSTM's recurrent weights and bias.  Names match anywhere in the tree;
# no other leaf carries one of them.
F32_LEAVES = ("router", "scale", "a_log", "dt_bias", "w_gates", "b_gates",
              "r_h", "b")

_MIXER_INIT = {"attn": attn.attn_init, "mamba": ssm.mamba_init,
               "mlstm": ssm.mlstm_init, "slstm": ssm.slstm_init}
FFNS = ("dense", "moe", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a pattern with a mixer or FFN the model does not know (the
    reference's ``_block_init`` raises ``ValueError`` for them too)."""
    for spec in cfg.pattern:
        if spec.mixer not in _MIXER_INIT:
            raise ValueError(f"unknown mixer {spec.mixer!r}")
        if spec.ffn not in FFNS:
            raise ValueError(f"unknown ffn {spec.ffn!r}")


def n_scan_units(cfg: ModelConfig) -> int:
    """Pattern units after the dense first block (all of them without)."""
    return cfg.n_units - (1 if cfg.first_layer_dense else 0)


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Specs of ``params["layers"]``: the units' blocks, in order."""
    width = len(cfg.pattern)
    return [cfg.pattern[i % width] for i in range(n_scan_units(cfg) * width)]


def _first_spec(cfg: ModelConfig) -> LayerSpec:
    return LayerSpec(mixer=cfg.pattern[0].mixer, ffn="dense")


# ===================================================================== #
# Parameter init
# ===================================================================== #


def _block_init(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device) -> dict:
    """One block's parameters; a block with ``ffn="none"`` has no
    ``norm2`` and no ``ffn``, as in the reference."""
    p = {"norm1": rmsnorm_init(cfg.d_model, device),
         "mixer": _MIXER_INIT[spec.mixer](gen, cfg, dtype, device)}
    if spec.ffn == "none":
        return p
    p["norm2"] = rmsnorm_init(cfg.d_model, device)
    if spec.ffn == "dense":
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.n_layers, dtype,
                            device)
    else:
        p["ffn"] = moe_mod.moe_init(gen, cfg, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda", cast: bool = True,
                par: Parallel | None = None) -> dict:
    """Random weights drawn in ``cfg.param_dtype`` on ``device``.

    With ``cast`` (serve) each block is cast by :func:`cast_for_compute`
    as soon as it is drawn: the values are those of drawing the whole
    model in ``param_dtype`` and casting it after, and the peak is the
    cast model plus one block.  ``cast=False`` (training) keeps every
    leaf in ``param_dtype``, the reference's master weights.
    ``generator`` must live on ``device``; None seeds one with 0.

    Under ``par``'s mesh the result is this rank's blocks
    (``ShardingRules.param_specs``): every weight is drawn whole, as
    without a mesh (so the blocks are those of the single-shard draw),
    and replaced by its block before the next one is drawn; the peak is
    the rank's blocks plus one whole weight.
    """
    check_supported(cfg)
    if par is not None and par.mesh is not None:
        return _init_blocks(cfg, generator, device, cast, par)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)

    def drawn(node: dict) -> dict:
        return cast_for_compute(cfg, node) if cast else node

    params: dict = drawn({
        "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    })
    if not cfg.tie_embeddings:
        params.update(drawn({"head": normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype, dev)}))
    if cfg.first_layer_dense:
        params["first"] = drawn(_block_init(gen, _first_cfg(cfg),
                                            _first_spec(cfg), dtype, dev))
    params["layers"] = [drawn(_block_init(gen, cfg, spec, dtype, dev))
                        for spec in layer_specs(cfg)]
    return params


def _paths(tree, path=()):
    """(path, leaf) of every tensor leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _init_blocks(cfg, generator, device, cast: bool, par: Parallel) -> dict:
    """``init_params`` under a mesh (its docstring).  A first draw on
    ``meta`` finds which leaf each drawn weight becomes; the real draw
    then hands each weight to ``layers.leaf_hook``, which replaces it by
    its block at once.  A drawn weight that is transformed before it
    becomes a leaf (an EP-slotted stack) is cut after its block is drawn."""
    from . import layers
    rules = par.rules(cfg)
    made: list = []
    layers.leaf_hook = lambda w: made.append(w) or w
    try:
        meta = init_params(cfg, torch.Generator(), "meta", cast=False)
    finally:
        layers.leaf_hook = None
    specs = rules.param_specs(meta)
    where = {id(t): p for p, t in _paths(meta)}
    order = iter([where.get(id(t)) for t in made])
    done: set = set()

    def spec_of(path):
        node = specs
        for k in path:
            node = node[k]
        return node

    cdt = dtype_of(cfg.compute_dtype)

    def hook(w):
        path = next(order)
        if path is None:
            return w
        w = rank_block(w, spec_of(path), par.mesh, path[-1] in FUSED)
        if cast and path[-1] not in F32_LEAVES:
            w = w.to(cdt)              # as ``cast_for_compute`` casts it
        done.add(id(w))
        return w

    layers.leaf_hook = hook
    try:
        params = init_params(cfg, generator, device, cast=False)
    finally:
        layers.leaf_hook = None

    def rest(node, path):        # the leaves the hook did not see
        if isinstance(node, dict):
            return {k: rest(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [rest(v, path + (i,)) for i, v in enumerate(node)]
        if id(node) in done:
            return node
        return rank_block(node, spec_of(path), par.mesh, path[-1] in FUSED)
    params = rest(params, ())
    return cast_for_compute(cfg, params) if cast else params


def cast_for_compute(cfg: ModelConfig, params):
    """Cast every weight except ``F32_LEAVES`` to the compute dtype, once
    (see the module docstring); tensors are replaced one by one, so peak
    memory grows by one tensor, not by a copy of the model."""
    cdt = dtype_of(cfg.compute_dtype)

    def walk(node, name=""):
        if isinstance(node, dict):
            for k in list(node):
                node[k] = walk(node[k], k)
            return node
        if isinstance(node, list):
            for i in range(len(node)):
                node[i] = walk(node[i], name)
            return node
        return node if name in F32_LEAVES else node.to(cdt)

    return walk(params)


# ===================================================================== #
# Block application (forward / prefill / decode share this)
# ===================================================================== #


_RECURRENT = {"mamba": (ssm.mamba_forward, ssm.mamba_decode),
              "mlstm": (ssm.mlstm_forward, ssm.mlstm_decode)}


def _apply_mixer(cfg, spec, mp, x, positions, par, cdt, cache, mode):
    """Returns (y, cache): the KV cache written in place, or the new
    recurrent state (prefill and decode run the same step)."""
    if spec.mixer == "attn":
        if mode == "forward":
            return attn.attention_forward(cfg, mp, x, positions, cdt,
                                          par), None
        if mode == "prefill":
            return attn.attention_prefill(cfg, mp, x, positions, cache, cdt,
                                          par)
        return attn.attention_decode(cfg, mp, x, positions, cache, cdt, par)
    if spec.mixer == "slstm":
        if mode == "forward":
            return ssm.slstm_forward(cfg, mp, x, cdt), None
        return ssm.slstm_decode(cfg, mp, x, cache, cdt)
    fwd, dec = _RECURRENT[spec.mixer]
    if mode == "forward":
        return fwd(cfg, mp, x, cdt, par), None
    return dec(cfg, mp, x, cache, cdt, par)


def _apply_moe(cfg, bp_ffn, x, par: Parallel, cdt):
    """The MoE block: local math, the "local" mode over ``par``'s mesh
    (``moe.moe_apply_sharded``), or the EP body ``par`` resolves to."""
    mode = par.resolve_moe(cfg, x.shape[1])
    if mode != "local":
        return apply_ep(cfg, bp_ffn, x, par, cdt, mode)
    if par.mesh is None or (not par.dp and par.model_size == 1):
        return moe_mod.moe_apply_local(cfg, bp_ffn, x, cdt)
    return moe_mod.moe_apply_sharded(cfg, bp_ffn, x, cdt, par)


def apply_ep(cfg, bp_ffn, x, par: Parallel, cdt, mode: str):
    """The EP body ``mode`` ("ep" or "ep_rep") over ``par``'s mesh through
    ``moe.sharded_moe``, with the reference's in/out specs
    (``repro/models/model.py:_apply_moe``); at any model-axis size, one
    included.  ``x`` is the rank's data rows and the expert stacks its
    blocks; the shared experts run outside the body, split over the model
    axis as the rules shard them (the reference's body runs them whole on
    its tokens: the same sums in another order)."""
    batch_axes = par.data_axes if len(par.data_axes) > 1 else par.data_axes[0]
    if not par.dp:                   # e.g. long-context batch=1 decode
        batch_axes = None
    in_params_spec = {k: P(par.model_axis) for k in ("w_gate", "w_up", "w_down")}
    in_params_spec["router"] = P()
    aux_spec = {"load_balance_loss": P(), "router_z_loss": P(),
                "expert_counts": P()}
    if mode == "ep":
        # sequence-sharded dispatch: tokens split over the EP axis
        x_spec = P(batch_axes, par.model_axis, None)
        body = moe_mod.moe_apply_ep
    elif mode == "ep_rep":
        # replicated tokens (decode): local experts + all-reduce combine
        x_spec = P(batch_axes, None, None)
        body = moe_mod.moe_apply_ep_replicated
    else:
        raise ValueError(mode)
    sharded = moe_mod.sharded_moe(
        lambda p, xx: body(cfg, p, x_local=xx, axis_name=par.model_axis,
                           compute_dtype=cdt, mesh=par.mesh),
        mesh=par.mesh, in_specs=(in_params_spec, x_spec),
        out_specs=(x_spec, aux_spec), axis=par.model_axis)
    y, aux = sharded({k: bp_ffn[k] for k in in_params_spec}, x)
    if "shared" in bp_ffn:
        y = y + ffn_apply(bp_ffn["shared"], x, cdt, par,
                          cfg.d_ff_expert * cfg.n_shared_experts)
    return y, aux


def _apply_block(cfg, spec, bp, x, positions, par, cdt, cache, mode):
    """Returns (x, cache, aux); aux is the MoE router's aux dict or None."""
    aux = None
    h = rmsnorm(bp["norm1"], x, cfg.norm_eps)
    y, cache = _apply_mixer(cfg, spec, bp["mixer"], h, positions, par, cdt,
                            cache, mode)
    x = x + y
    if spec.ffn == "none":
        return x, cache, aux
    h = rmsnorm(bp["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        x = x + ffn_apply(bp["ffn"], h, cdt, par, cfg.d_ff)
    else:
        out, aux = _apply_moe(cfg, bp["ffn"], h, par, cdt)
        x = x + out
    return x, cache, aux


def _embed_inputs(cfg, params, batch, cdt, par=None):
    """batch: dict with 'tokens' (B, S_t) and/or 'embeds' (B, S_e, d);
    embeddings come first, and positions run over the whole prompt."""
    parts = []
    if "embeds" in batch:
        parts.append(batch["embeds"].to(cdt))
    if "tokens" in batch:
        parts.append(embed(params["embed"], batch["tokens"], cdt, par,
                           cfg.padded_vocab))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None] \
        .expand(b, s)
    return x, positions


def _logits(cfg, params, x, par=None):
    """Logits over the padded vocab; under ``par`` the rank's columns."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return lm_head(table, x, cfg.tie_embeddings, par, cfg.padded_vocab)


def _first_cfg(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` of the dense first block (its FFN width)."""
    return dataclasses.replace(cfg, d_ff=cfg.first_dense_d_ff or cfg.d_ff)


def gather_logits(cfg, logits: torch.Tensor, par: Parallel) -> torch.Tensor:
    """The global logits (B, ..., V_padded) on every rank, from the rank's
    block (its data rows, its vocab columns)."""
    if par.mesh is None:
        return logits
    if par.split(cfg.padded_vocab):
        logits = collectives.gather_from(logits, -1, par.model_group())
    if par.dp:
        logits = collectives.gather_from(logits, 0, par.data_group())
    return logits


# ===================================================================== #
# Full passes
# ===================================================================== #


def _apply_unit(cfg, unit_params, x, positions, par, cdt):
    """One pattern unit of the forward pass: (x, aux, counts (E,)), the aux
    and counts summed over its MoE blocks in the reference's order."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros((max(cfg.n_experts, 1),), dtype=torch.float32,
                         device=x.device)
    for spec, bp in zip(cfg.pattern, unit_params):
        x, _, aux = _apply_block(cfg, spec, bp, x, positions, par, cdt, None,
                                 "forward")
        if aux is not None:
            aux_sum = aux_sum + aux["load_balance_loss"] \
                + 1e-3 * aux["router_z_loss"]
            counts = counts + aux["expert_counts"]
    return x, aux_sum, counts


def _takes_grad(params: dict) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params["layers"]))


def forward(cfg: ModelConfig, params: dict, batch: dict,
            par: Parallel = Parallel(), return_router_stats: bool = False):
    """Forward pass: returns (logits (B,S,V_padded), aux_loss); under a
    mesh the logits are the rank's block (its rows, its vocab columns:
    ``gather_logits`` puts them together).

    With ``return_router_stats`` also returns per-unit expert-selection
    counts (n_scan_units, n_experts): the activation statistics that feed
    the SpaceMoE placement planner (Eq. 14 plug-in); the dense first
    block has no row.  Units run under ``checkpoint`` when
    ``cfg.remat == "unit"`` and a grad is to be taken (module docstring).
    """
    cdt = dtype_of(cfg.compute_dtype)
    x, positions = _embed_inputs(cfg, params, batch, cdt, par)
    n_units = n_scan_units(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    counts = torch.zeros((n_units, max(cfg.n_experts, 1)),
                         dtype=torch.float32, device=x.device)
    if cfg.first_layer_dense:
        x, _, _ = _apply_block(_first_cfg(cfg), _first_spec(cfg),
                               params["first"], x, positions, par, cdt, None,
                               "forward")
    remat = cfg.remat == "unit" and _takes_grad(params)
    width = len(cfg.pattern)
    for u in range(n_units):
        unit = params["layers"][u * width:(u + 1) * width]
        if remat:
            x, aux, counts_u = checkpoint(_apply_unit, cfg, unit, x,
                                          positions, par, cdt,
                                          use_reentrant=False,
                                          preserve_rng_state=False)
        else:
            x, aux, counts_u = _apply_unit(cfg, unit, x, positions, par, cdt)
        aux_total = aux_total + aux
        counts[u] = counts_u
    logits = _logits(cfg, params, x, par)
    if return_router_stats:
        return logits, aux_total, counts
    return logits, aux_total


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            par: Parallel = Parallel(), aux_weight: float = 0.01):
    """Next-token cross-entropy (+ MoE aux): (loss, {"ce", "aux"}).

    batch["labels"]: (B, S) int, -1 => ignore.  The log-softmax runs in
    f32 over the padded vocab, as the reference's.  (The reference's data
    pipeline gives the input tokens themselves as labels, unshifted.)
    Under a mesh the logits are the rank's vocab columns: the log-sum-exp
    comes from the max, the sum of exponentials and the label's logit,
    each taken over the model axis; and the mean is over the global batch
    (the sums of the rank's rows and counts, taken over the data axes).
    """
    logits, aux = forward(cfg, params, batch, par)
    labels = batch["labels"]
    s = min(logits.shape[1], labels.shape[1])
    logits = logits[:, -s:].float()
    labels = labels[:, -s:].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    if par.split(cfg.padded_vocab):
        group = par.model_group()
        cols = logits.shape[-1]
        top = collectives.all_max(logits.amax(dim=-1, keepdim=True), group)
        total = collectives.reduce_from(
            torch.exp(logits - top).sum(dim=-1), group)
        local = safe - par.model_rank() * cols
        inside = (local >= 0) & (local < cols)
        picked = torch.gather(logits, -1, torch.where(
            inside, local, torch.zeros_like(local))[..., None])[..., 0]
        picked = collectives.reduce_from(picked * inside.to(picked.dtype),
                                         group)
        nll = top[..., 0] + torch.log(total) - picked
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    nll_sum, count = nll.sum(), valid.sum()
    if par.dp:
        nll_sum = collectives.reduce_from(nll_sum, par.data_group())
        count = collectives.all_reduce(count, par.data_group())
    ce = nll_sum / torch.clamp(count, min=1)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _block_cache(cfg, spec: LayerSpec, batch: int, max_len: int, cdt, dev):
    if spec.mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, cdt, dev)
    init_state = {"mamba": ssm.mamba_init_state, "mlstm": ssm.mlstm_init_state,
                  "slstm": ssm.slstm_init_state}[spec.mixer]
    return init_state(cfg, batch, dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", par: Parallel | None = None) -> dict:
    """Decode cache: one entry per layer, a KV cache in the compute dtype
    for attention and the f32 recurrent state for the other mixers.
    ``batch`` is the global batch; under ``par``'s mesh the cache is the
    rank's blocks (``ShardingRules.cache_specs``), made one layer at a
    time: its rows, its KV heads where they divide the model axis, and
    with ``par.context`` its block of the sequence."""
    check_supported(cfg)
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    mesh = par.mesh if par is not None else None
    rows = batch // par.n_data if mesh is not None and par.dp else batch
    seq = max_len
    specs = None
    if mesh is not None:
        rules = par.rules(cfg)
        specs = rules.cache_specs(init_cache(cfg, batch, max_len, "meta"))
        kv = torch.empty((batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                         device="meta")
        split = rules.cache_spec(("k",), kv)[1] is not None \
            and par.n_data > 1
        if split != par.cp and any(s.mixer == "attn" for s in cfg.pattern):
            raise ValueError(
                f"the rules {'split' if split else 'keep'} the cache's "
                f"sequence of {max_len} over {par.n_data} data ranks, "
                f"Parallel(context={par.context}) says otherwise")
        if par.cp:
            seq = max_len // par.n_data

    def made(spec_node, layer_spec):
        block = _block_cache(cfg, layer_spec, rows, seq, cdt, dev)
        if spec_node is None:
            return block
        # Rows (and the sequence) already cut: the blocks along the
        # model axis only.
        def rest(name, spec):
            cut = 2 if name in ("k", "v") else 1
            return P(*([None] * cut), *spec[cut:])
        return shard_tree(block, {k: rest(k, v) for k, v in spec_node.items()},
                          mesh)

    cache = {"layers": [made(specs and specs["layers"][i], spec)
                        for i, spec in enumerate(layer_specs(cfg))]}
    if cfg.first_layer_dense:
        cache["first"] = made(specs and specs["first"], cfg.pattern[0])
    return cache


def _run_stack(cfg, params, cache, x, positions, par, cdt, mode):
    """Every block in order, each layer's cache entry replaced by what its
    block returns (the same KV cache, or the new recurrent state)."""
    if cfg.first_layer_dense:
        x, cache["first"], _ = _apply_block(
            _first_cfg(cfg), _first_spec(cfg), params["first"], x, positions,
            par, cdt, cache["first"], mode)
    layers = cache["layers"]
    for i, (spec, bp) in enumerate(zip(layer_specs(cfg), params["layers"])):
        x, layers[i], _ = _apply_block(cfg, spec, bp, x, positions, par, cdt,
                                       layers[i], mode)
    return x


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int,
            par: Parallel = Parallel()):
    """Run the prompt through the stack: (last-token logits (B, V), cache).

    Attention blocks write K/V for positions [0, S); recurrent blocks
    carry their final state.  Under a mesh the logits and the cache are
    the rank's blocks.
    """
    cdt = dtype_of(cfg.compute_dtype)
    x, positions = _embed_inputs(cfg, params, batch, cdt, par)
    rows = x.shape[0] * (par.n_data if par.dp else 1)
    cache = init_cache(cfg, rows, max_len, x.device, par)
    x = _run_stack(cfg, params, cache, x, positions, par, cdt, "prefill")
    logits = _logits(cfg, params, x[:, -1:, :], par)
    return logits[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor | None, pos: torch.Tensor,
                par: Parallel = Parallel(),
                embeds: torch.Tensor | None = None):
    """One autoregressive step; updates ``cache`` in place.

    tokens: (B, 1) int32 (or ``embeds`` (B, 1, d) for stub frontends, in
    which case ``tokens`` is not read); pos: (B,) int32 positions of these
    tokens.  Returns (logits (B, V), cache).  Under a mesh tokens, embeds,
    the cache and the logits are the rank's blocks, and ``pos`` is whole
    (the reference's ``in_shardings`` leave it so): the rank reads its
    rows of it.
    """
    cdt = dtype_of(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(cdt)
    else:
        x = embed(params["embed"], tokens, cdt, par, cfg.padded_vocab)
    x = _run_stack(cfg, params, cache, x, par.rows(pos), par, cdt, "decode")
    logits = _logits(cfg, params, x, par)
    return logits[:, 0, :], cache
