"""Layer computation latency (paper Sec. V, Eq. 33/36/37 + Lemma 1-2).

Given I candidate satellites sorted by expected path latency
tau_1 <= ... <= tau_I and a permutation assigning expert e to latency rank
s, the expected layer latency under the conditional-Poisson top-K model is

    tau_c(X) = sum_s (1 - Pr(R_X < s)) * (tau_s - tau_{s-1})     (Lemma 1)
    Pr(R_X < s) = e_K(w~_1..w~_{s-1}) / e_K(w_1..w_I)            (Lemma 2)

with w~_s the importance weight of the expert placed at rank s.  This is
exact and O(I*K) — it is both the optimization objective and the unit-test
oracle for the Monte-Carlo simulator.

Counterpart of ``repro.core.objective`` (host numpy, held bitwise to it).
"""
from __future__ import annotations

import itertools

import numpy as np

from .activation import esp_prefix_table, sample_topk


def layer_latency_closed_form(
    tau_sorted: np.ndarray, weights: np.ndarray, rank_to_expert: np.ndarray, k: int
) -> float:
    """Exact expected layer latency tau_c for one placement.

    Parameters
    ----------
    tau_sorted:     (I,) expected path latencies of the I used satellites,
                    ascending (rank order).
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
    # Pr(R_X < s) for s = 1..I  (prefix of length s-1).
    cdf = table[0:n, k] / e_total
    delta = np.diff(np.concatenate([[0.0], tau_sorted]))
    return float(np.sum((1.0 - cdf) * delta))


def layer_latency_monte_carlo(
    tau_sorted: np.ndarray,
    weights: np.ndarray,
    rank_to_expert: np.ndarray,
    k: int,
    rng: np.random.Generator,
    n_draws: int = 20000,
) -> float:
    """MC estimate of tau_c — cross-validates the closed form."""
    expert_to_rank = np.empty_like(rank_to_expert)
    expert_to_rank[np.asarray(rank_to_expert)] = np.arange(len(rank_to_expert))
    draws = sample_topk(weights, k, rng, n_draws)          # expert ids
    ranks = expert_to_rank[draws]
    return float(np.asarray(tau_sorted)[ranks].max(axis=1).mean())


def brute_force_optimal(
    tau_sorted: np.ndarray, weights: np.ndarray, k: int
) -> tuple[np.ndarray, float]:
    """Exhaustive search over all I! placements (test oracle, I <= 8)."""
    n = len(weights)
    best_perm, best_val = None, np.inf
    for perm in itertools.permutations(range(n)):
        val = layer_latency_closed_form(tau_sorted, weights, np.asarray(perm), k)
        if val < best_val - 1e-15:
            best_perm, best_val = np.asarray(perm), val
    return best_perm, float(best_val)
