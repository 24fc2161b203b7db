"""Layer computation latency (paper Sec. V, Eq. 33 + Lemma 1-2), host numpy.

Given I candidate slots sorted by expected path latency
tau_1 <= ... <= tau_I and a permutation assigning expert e to latency rank
s, the expected layer latency under the conditional-Poisson top-K model is

    tau_c(X) = sum_s (1 - Pr(R_X < s)) * (tau_s - tau_{s-1})     (Lemma 1)
    Pr(R_X < s) = e_K(w~_1..w~_{s-1}) / e_K(w_1..w_I)            (Lemma 2)

Counterpart of ``repro.core.objective.layer_latency_closed_form``.
"""
from __future__ import annotations

import numpy as np

from .activation import esp_prefix_table


def layer_latency_closed_form(
    tau_sorted: np.ndarray, weights: np.ndarray, rank_to_expert: np.ndarray, k: int
) -> float:
    """Exact expected layer latency tau_c for one placement.

    tau_sorted:     (I,) expected path latencies, ascending (rank order).
    weights:        (I,) expert importance weights (expert order).
    rank_to_expert: (I,) permutation; rank_to_expert[s] = expert at rank s.
    k:              top-K.
    """
    tau_sorted = np.asarray(tau_sorted, dtype=np.float64)
    n = len(tau_sorted)
    if np.any(np.diff(tau_sorted) < -1e-12):
        raise ValueError("tau_sorted must be ascending")
    w_perm = np.asarray(weights, dtype=np.float64)[np.asarray(rank_to_expert)]
    table = esp_prefix_table(w_perm, k)            # E[i, k] = e_k(w~_1..i)
    e_total = table[n, k]
    cdf = table[0:n, k] / e_total                  # Pr(R_X < s), s = 1..I
    delta = np.diff(np.concatenate([[0.0], tau_sorted]))
    return float(np.sum((1.0 - cdf) * delta))
