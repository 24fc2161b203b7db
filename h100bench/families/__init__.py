"""Architecture families: one module a family, ``families/<family>.py``,
named by a configuration file's ``"family"`` key and loaded by
``harness.family``.  A new architecture enters the benchmark as a new
module here; the harness, the yardstick and the metric readers stay as
they are.  A family module provides:

* ``Sizes``, a frozen dataclass of the sizes the family reads from a
  configuration file's ``model`` group, and ``sizes_of(model)``, which
  refuses a group with a key missing or a key the family does not know
  (``sizes_from``);
* ``smoke(sizes)``: the same structure at a size the CPU runs in seconds;
* ``leaf_specs(sizes)``: (path, shape, std, kind) of every weight, in draw
  order (``inputs.draw_weights`` draws them);
* ``want(sizes)``: the port's ``ModelConfig`` attributes the sizes fix,
  with their values, and ``smoke_config(sizes)``: the ``ModelConfig``
  fields set for the smoke-size model;
* the reference, plain PyTorch in f32 that imports nothing of the
  program: ``serve_logits(sizes, params, prompts, fed, prec)`` and
  ``loss(sizes, params, tokens, labels, prec, aux_weight)``;
* the work counts: ``token_matmul_params(sizes)``, ``pair_flops(sizes)``
  (one visible (query, key) pair over all layers), ``head_flops(sizes,
  n_logits)``, ``gmm_need(sizes, n_tokens, backward)`` and
  ``decode_attn_row_bytes(sizes, pos)`` (what decode attention reads and
  writes for one row at ``pos``, over all layers).
"""
from __future__ import annotations

import dataclasses


def sizes_from(cls, model: dict, family: str):
    """``cls`` (family ``family``'s ``Sizes``) from a ``model`` group that
    names each of its fields and nothing else."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown, missing = sorted(set(model) - fields), sorted(fields - set(model))
    if unknown or missing:
        raise ValueError(f"family {family}: the model group has keys the "
                         f"family does not know {unknown} and lacks "
                         f"{missing}")
    return cls(**model)
