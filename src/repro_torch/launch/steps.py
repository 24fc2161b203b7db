"""Step functions (counterpart of ``repro.launch.steps``): the train step
and the serve step.

No ``Parallel`` argument yet: one device runs the whole step (sharding is
a later slice).  ``input_specs`` and the ShapeDtypeStruct helpers belong
to the dry-run tools, not ported.
"""
from __future__ import annotations

import torch

from ..models import decode_step, loss_fn
from ..models.config import ModelConfig
from ..optim import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_map, tree_unflatten


def _value_and_grad(cfg: ModelConfig, params, batch):
    """((loss, metrics), grads): grads in each leaf's dtype, zeros for a
    leaf the loss does not reach (as ``jax.value_and_grad``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    schedule=None, micro_batches: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch)`` returns
    (params, opt_state, metrics with loss, ce, aux and grad_norm).

    With ``micro_batches > 1`` the global batch is run as that many
    gradient-accumulation slices (a Python loop where the reference
    scans): f32 grads summed, then divided, losses averaged.  Params and
    opt_state are updated in place (``adamw_update``), as the reference's
    jitted step donates them.
    """
    schedule = schedule or (lambda s: 1.0)

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = _value_and_grad(cfg, params, batch)
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
                    cfg, params, {k: v[i] for k, v in mb.items()})
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


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token + logits, cache updated in place.

    ``embeds`` (B, 1, d) feeds the stub audio frontend in place of the
    tokens, as the reference's positional ``embeds`` argument does; pass
    None (the default) for token-input architectures.
    """

    def serve_step(params, cache, tokens, pos, embeds=None):
        logits, cache = decode_step(cfg, params, cache, tokens, pos,
                                    embeds=embeds)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step
