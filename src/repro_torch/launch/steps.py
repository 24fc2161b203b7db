"""Step functions and meta-device input stand-ins (counterpart of
``repro.launch.steps``).

The train, prefill and serve steps take ``par`` (``models.Parallel``) as
the reference's do.  ``input_specs(cfg, shape)`` gives every input of
one (arch x shape) cell as tensors on the ``meta`` device, where the
reference gives ``ShapeDtypeStruct``s: shapes and dtypes, no storage.
``param_structs`` draws ``init_params`` on ``meta`` (with a CPU
generator: ``torch.Generator`` has no meta device, and a meta draw reads
none of its state), in ``cfg.param_dtype`` as the reference's structs.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.shapes import ShapeSpec
from ..models import (Parallel, batch_specs, decode_step, init_cache,
                      init_params, loss_fn, prefill)
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_leaves, tree_map, tree_unflatten


def _value_and_grad(cfg: ModelConfig, par: Parallel, params, batch):
    """((loss, metrics), grads): grads in each leaf's dtype, zeros for a
    leaf the loss does not reach (as ``jax.value_and_grad``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch, par)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, par: Parallel,
                    opt_cfg: AdamWConfig = AdamWConfig(), schedule=None,
                    micro_batches: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch)`` returns
    (params, opt_state, metrics with loss, ce, aux and grad_norm).

    With ``micro_batches > 1`` the global batch is run as that many
    gradient-accumulation slices (a Python loop where the reference
    scans): f32 grads summed, then divided, losses averaged.  Params and
    opt_state are updated in place (``adamw_update``), as the reference's
    jitted step donates them.  Under a mesh the reference pins the
    micro-batch slices to the data axes; a per-rank program holds each
    slice whole and has no layout to pin.
    """
    schedule = schedule or (lambda s: 1.0)

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = _value_and_grad(cfg, par, params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % micro_batches:
                    raise ValueError(
                        f"batch {b} not divisible by {micro_batches} slices")
                return x.reshape(micro_batches, b // micro_batches,
                                 *x.shape[1:])

            mb = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            ls, ces, auxs = [], [], []
            for i in range(micro_batches):
                (l, m), g = _value_and_grad(
                    cfg, par, params, {k: v[i] for k, v in mb.items()})
                grads = tree_map(torch.add, grads, g)
                ls.append(l)
                ces.append(m["ce"])
                auxs.append(m["aux"])
                del g        # free this slice's grads before the next's
            grads = tree_map(lambda g: g / micro_batches, grads)
            loss = torch.stack(ls).mean()
            metrics = {"ce": torch.stack(ces).mean(),
                       "aux": torch.stack(auxs).mean()}
        params, opt_state, gnorm = adamw_update(
            opt_cfg, params, grads, opt_state, schedule(opt_state["count"]))
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
    """

    def serve_step(params, cache, tokens, pos, embeds=None):
        logits, cache = decode_step(cfg, params, cache, tokens, pos, par=par,
                                    embeds=embeds)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


# --------------------------------------------------------------------- #
# Meta-device stand-ins
# --------------------------------------------------------------------- #


def param_structs(cfg: ModelConfig) -> dict:
    return init_params(cfg, torch.Generator(), "meta", cast=False)


def opt_structs(params_structs) -> dict:
    return adamw_init(params_structs)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return init_cache(cfg, batch, max_len, "meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """All inputs of one (arch x shape) cell, as meta tensors.

    train:   {params, opt_state, batch}
    prefill: {params, batch}            (batch without labels)
    decode:  {params, cache, tokens, pos [, embeds]}
    """
    p = param_structs(cfg)
    if shape.kind == "train":
        return {
            "params": p,
            "opt_state": opt_structs(p),
            "batch": batch_specs(cfg, shape.global_batch, shape.seq_len),
        }
    if shape.kind == "prefill":
        b = batch_specs(cfg, shape.global_batch, shape.seq_len)
        b.pop("labels")
        return {"params": p, "batch": b}
    if shape.kind == "decode":
        out = {
            "params": p,
            "cache": cache_structs(cfg, shape.global_batch, shape.seq_len),
            "pos": torch.empty((shape.global_batch,), dtype=torch.int32,
                               device="meta"),
        }
        if cfg.frontend == "audio":
            out["tokens"] = None
            out["embeds"] = torch.empty(
                (shape.global_batch, 1, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        else:
            out["tokens"] = torch.empty((shape.global_batch, 1),
                                        dtype=torch.int32, device="meta")
        return out
    raise ValueError(shape.kind)
