"""Expert-activation model (paper Sec. III-C), host numpy.

The top-K active expert set follows the conditional-Poisson distribution
the paper calls PPSWOR:

    Pr(S_hat = U) = prod_{i in U} w_i / e_K(w_1..w_I)        (Eq. 12)

with e_K the K-th elementary symmetric polynomial (Eq. 13) and per-expert
activation probability

    P_i = 1 - e_K(w \\ i) / e_K(w)                            (Eq. 14).

Counterpart of ``repro.core.activation`` for the serve path's placement:
the same float64 dynamic programs, held bitwise to the reference.
"""
from __future__ import annotations

import numpy as np


def esp(weights: np.ndarray, k_max: int) -> np.ndarray:
    """e_0..e_{k_max} of ``weights`` — Newton DP, O(I*K).

    Weights are pre-scaled by their mean for numerical range; the scaling
    is undone exactly (e_k(c*w) = c^k e_k(w)).
    """
    w = np.asarray(weights, dtype=np.float64)
    scale = w.mean() if w.size else 1.0
    if scale <= 0:
        raise ValueError("importance weights must be positive")
    ws = w / scale
    e = np.zeros(k_max + 1, dtype=np.float64)
    e[0] = 1.0
    for wi in ws:
        e[1 : k_max + 1] = e[1 : k_max + 1] + wi * e[0:k_max]
    return e * scale ** np.arange(k_max + 1)


def esp_prefix_table(weights: np.ndarray, k_max: int) -> np.ndarray:
    """E[i, k] = e_k(w_1..w_i), shape (I+1, K+1) — scaled-stable DP."""
    w = np.asarray(weights, dtype=np.float64)
    scale = w.mean() if w.size else 1.0
    ws = w / scale
    n = len(ws)
    table = np.zeros((n + 1, k_max + 1), dtype=np.float64)
    table[:, 0] = 1.0
    for i in range(1, n + 1):
        table[i, 1:] = table[i - 1, 1:] + ws[i - 1] * table[i - 1, :-1]
    return table * scale ** np.arange(k_max + 1)[None, :]


def activation_probs(weights: np.ndarray, k: int) -> np.ndarray:
    """P_i = Pr(i in S_hat) via Eq. 14: 1 - e_K(w \\ i) / e_K(w).

    Each leave-one-out ESP is computed by a direct DP over the remaining
    I-1 weights (all-positive additions, unconditionally stable).
    """
    w = np.asarray(weights, dtype=np.float64)
    n = len(w)
    if k >= n:
        return np.ones(n)
    ws = w / w.mean()
    e_full = esp(ws, k)[k]
    probs = np.empty(n)
    for i in range(n):
        loo = esp(np.delete(ws, i), k)[k]
        probs[i] = 1.0 - loo / e_full
    return probs
