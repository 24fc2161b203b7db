"""Theorem-1 intra-layer assignment (paper Sec. V), host numpy.

Counterpart of ``repro.core.placement.theorem1_assignment``; the
constellation-level planners (``spacemoe_plan`` and the baselines) belong
to a later slice of the port.
"""
from __future__ import annotations

import numpy as np


def theorem1_assignment(
    activation_probs: np.ndarray, tau_bar: np.ndarray
) -> np.ndarray:
    """Theorem 1: expert with i-th highest P -> candidate with i-th lowest tau.

    activation_probs: (I,) per-expert activation probabilities.
    tau_bar:          (C,) expected path latency per candidate, C >= I.

    Returns (I,) candidate indices: entry i = candidate hosting expert i.
    """
    n_exp = len(activation_probs)
    if len(tau_bar) < n_exp:
        raise ValueError("fewer candidate satellites than experts")
    # Stable sorts for deterministic tie-breaking.
    expert_order = np.argsort(-np.asarray(activation_probs), kind="stable")
    sat_order = np.argsort(np.asarray(tau_bar), kind="stable")[:n_exp]
    assign = np.empty(n_exp, dtype=np.int64)
    assign[expert_order] = sat_order
    return assign
