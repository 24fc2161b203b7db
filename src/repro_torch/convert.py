"""Carry the reference's weights into the port.

``params_from_jax(cfg, params)`` takes the reference's parameter pytree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on
the caller's side; this module imports no JAX) and returns the port's
parameters: the same arrays in the same layout, with the reference's
leading ``units`` axis unstacked into the per-layer list.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.config import ModelConfig
from .models.model import check_supported


def _tree(node, device, pick=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, pick) for k, v in node.items()}
    a = np.asarray(node) if pick is None else np.asarray(node)[pick]
    return torch.from_numpy(np.array(a)).to(device)   # a copy: jax's are read-only


def params_from_jax(cfg: ModelConfig, params: dict, device="cuda") -> dict:
    """The reference's parameters (numpy leaves) as the port's parameters."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = {k: _tree(params[k], dev) for k in ("embed", "final_norm", "head")
           if k in params}
    units = params["units"]
    out["layers"] = [_tree(units[f"b{i}"], dev, pick=u)
                     for u in range(cfg.n_units)
                     for i in range(len(cfg.pattern))]
    return out
