"""Expert-activation model (paper Sec. III-C), host numpy.

The top-K active expert set follows the conditional-Poisson distribution
the paper calls PPSWOR:

    Pr(S_hat = U) = prod_{i in U} w_i / e_K(w_1..w_I)        (Eq. 12)

with e_K the K-th elementary symmetric polynomial (Eq. 13) and per-expert
activation probability

    P_i = 1 - e_K(w \\ i) / e_K(w)                            (Eq. 14).

Counterpart of ``repro.core.activation``.  The numpy half (the serve
path's placement, the planners and the fleet simulator's expert draws)
keeps the same float64 dynamic programs and the same random stream, held
bitwise to the reference.  The reference's device forms are PyTorch
here, on the device of the tensor they are given:

    esp_jax               -> esp_torch
    activation_probs_jax  -> activation_probs_torch
    esp_prefix_table_jax  -> esp_prefix_table_torch
    sample_topk_jax       -> sample_topk_torch

They run in the dtype of their weights (float32 where the reference's
run without x64), take the reference's steps in its order, and accept
leading batch dimensions (weights ``(..., I)``), which the engine's
sampler uses for its layers.  ``sample_topk_torch`` draws its uniforms
from a ``torch.Generator`` (other bits than ``jax.random``) or takes
them explicitly, so that the same uniforms give the same draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def sample_topk(
    weights: np.ndarray, k: int, rng: np.random.Generator, n_draws: int = 1
) -> np.ndarray:
    """Exact conditional-Poisson samples of Eq. 12, shape (n_draws, K).

    Sequential ESP-ratio method: scanning items i = I..1 with ``r`` slots
    remaining, include item i with probability

        w_i * e_{r-1}(w_1..w_{i-1}) / e_r(w_1..w_i),

    which marginalizes exactly to Eq. 12.  Vectorized over draws.
    """
    w = np.asarray(weights, dtype=np.float64)
    n = len(w)
    if not (0 < k <= n):
        raise ValueError(f"need 0 < K <= I, got K={k}, I={n}")
    table = esp_prefix_table(w / w.mean(), k)      # scale cancels in ratios
    ws = w / w.mean()

    remaining = np.full(n_draws, k, dtype=np.int64)
    out = np.zeros((n_draws, k), dtype=np.int64)
    for i in range(n, 0, -1):
        r = remaining
        num = ws[i - 1] * table[i - 1, np.maximum(r - 1, 0)]
        den = table[i, r]
        with np.errstate(invalid="ignore", divide="ignore"):
            p = np.where(r > 0, num / den, 0.0)
        take = rng.random(n_draws) < p
        idx = np.where(take)[0]
        out[idx, remaining[idx] - 1] = i - 1
        remaining = remaining - take.astype(np.int64)
    assert (remaining == 0).all()
    return out


def subset_pmf(weights: np.ndarray, k: int) -> dict[tuple[int, ...], float]:
    """Exact PMF over all size-K subsets (enumeration; small I only)."""
    import itertools

    w = np.asarray(weights, dtype=np.float64)
    denom = esp(w, k)[k]
    return {
        u: float(np.prod(w[list(u)]) / denom)
        for u in itertools.combinations(range(len(w)), k)
    }


# --------------------------------------------------------------------- #
# Device forms (torch), composable on the card
# --------------------------------------------------------------------- #


def _mean_scaled(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = w.mean(dim=-1, keepdim=True)
    return w / scale, scale




def activation_probs_torch(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Eq. 14 on the device, the reference's ``activation_probs_jax``: the
    leave-one-out ESPs by the subtractive recurrence
    e_j(w \\ i) = e_j(w) - w_i e_{j-1}(w \\ i)."""
    w = torch.as_tensor(weights)
    ws, _ = _mean_scaled(w)
    e_full = esp_torch(ws, k)
    loo = torch.ones_like(ws)
    for j in range(1, k + 1):
        loo = e_full[..., j:j + 1] - ws * loo
    return 1.0 - loo / e_full[..., k:k + 1]


def esp_prefix_table_torch(weights: torch.Tensor, k_max: int) -> torch.Tensor:
    """E[..., i, k] = e_k(w_1..w_i) of mean-scaled weights, shape
    (..., I+1, K+1).  As in the reference's device form, the scale is not
    undone: it cancels in the sampling ratios."""
    w = torch.as_tensor(weights)
    ws, _ = _mean_scaled(w)
    row = torch.zeros(w.shape[:-1] + (k_max + 1,), dtype=w.dtype,
                      device=w.device)
    row[..., 0] = 1.0
    rows = [row]
    for i in range(w.shape[-1]):
        row = torch.cat([row[..., :1],
                         row[..., 1:] + ws[..., i:i + 1] * row[..., :-1]],
                        dim=-1)
        rows.append(row)
    return torch.stack(rows, dim=-2)


def esp_torch(weights: torch.Tensor, k_max: int) -> torch.Tensor:
    """e_0..e_{k_max} of ``weights`` (..., I): the DP of :func:`esp` (the
    prefix table's last row, the scale undone), shape (..., k_max + 1)."""
    w = torch.as_tensor(weights)
    _, scale = _mean_scaled(w)
    powers = torch.arange(k_max + 1, device=w.device)
    return esp_prefix_table_torch(w, k_max)[..., -1, :] * scale ** powers


def sample_topk_torch(weights: torch.Tensor, k: int, key,
                      n_draws: int | None = None) -> torch.Tensor:
    """Exact conditional-Poisson samples of Eq. 12 on the device, shape
    (..., n_draws, K), int64.

    The sequential ESP-ratio method of :func:`sample_topk` with the
    per-draw state vectorized, as the reference's ``sample_topk_jax``:
    item i = I..1 takes uniform row I - i.  ``key`` is a
    ``torch.Generator`` on the weights' device (then ``n_draws`` is
    required) or the uniforms themselves, shape (..., I, n_draws).
    """
    w = torch.as_tensor(weights)
    n = w.shape[-1]
    if not (0 < k <= n):
        raise ValueError(f"need 0 < K <= I, got K={k}, I={n}")
    if isinstance(key, torch.Generator):
        if n_draws is None:
            raise ValueError("a generator needs n_draws")
        u = torch.rand(w.shape + (n_draws,), generator=key, dtype=w.dtype,
                       device=w.device)
    else:
        u = torch.as_tensor(key, device=w.device)
        if u.shape[:-1] != w.shape or (n_draws is not None
                                       and u.shape[-1] != n_draws):
            raise ValueError(f"uniforms of shape {tuple(u.shape)} for "
                             f"weights {tuple(w.shape)}")
    lead = w.shape[:-1]
    w2 = w.reshape(-1, n)
    u2 = u.reshape(w2.shape[0], n, -1)
    table = esp_prefix_table_torch(w2, k)                  # (B, I+1, K+1)
    ws, _ = _mean_scaled(w2)
    b, t = u2.shape[0], u2.shape[2]
    remaining = torch.full((b, t), k, dtype=torch.int64, device=w.device)
    out = torch.zeros((b, t, k), dtype=torch.int64, device=w.device)
    slot = torch.arange(k, device=w.device)
    for i in range(n, 0, -1):
        num = ws[:, i - 1, None] * torch.gather(
            table[:, i - 1], 1, (remaining - 1).clamp(min=0))
        den = torch.gather(table[:, i], 1, remaining)
        p = torch.where(remaining > 0, num / den, torch.zeros_like(num))
        take = u2[:, n - i] < p
        write = take[..., None] & (slot == (remaining - 1)[..., None])
        out = torch.where(write, i - 1, out)
        remaining = remaining - take.to(torch.int64)
    return out.reshape(lead + (t, k))


@dataclasses.dataclass(frozen=True)
class ActivationModel:
    """Importance weights per MoE layer, shape (L, I); top-K per Eq. 12."""

    weights: np.ndarray      # (L, I) positive
    top_k: int

    def __post_init__(self):
        if (np.asarray(self.weights) <= 0).any():
            raise ValueError("importance weights must be positive")

    @property
    def n_layers(self) -> int:
        return self.weights.shape[0]

    @property
    def n_experts(self) -> int:
        return self.weights.shape[1]

    def probs(self, layer: int) -> np.ndarray:
        return activation_probs(self.weights[layer], self.top_k)

    def all_probs(self) -> np.ndarray:
        return np.stack([self.probs(l) for l in range(self.n_layers)])

    def sample(self, layer: int, rng: np.random.Generator, n_draws: int = 1) -> np.ndarray:
        return sample_topk(self.weights[layer], self.top_k, rng, n_draws)

    # -- constructors ---------------------------------------------------
    @staticmethod
    def zipf(n_layers: int, n_experts: int, top_k: int, s: float = 1.2,
             seed: int = 0) -> "ActivationModel":
        """Zipf-skewed weights with a per-layer random expert order.

        Real MoE gating statistics are heavy-tailed (a few hot experts per
        layer); the paper estimates them from LLaMA-MoE traces, which we do
        not have offline — Zipf(s) is the standard surrogate.
        """
        rng = np.random.default_rng(seed)
        base = (1.0 + np.arange(n_experts)) ** (-s)
        w = np.stack([rng.permutation(base) for _ in range(n_layers)])
        return ActivationModel(weights=w, top_k=top_k)

    @staticmethod
    def uniform(n_layers: int, n_experts: int, top_k: int) -> "ActivationModel":
        return ActivationModel(
            weights=np.ones((n_layers, n_experts)), top_k=top_k
        )

    @staticmethod
    def from_router_counts(counts: np.ndarray, top_k: int,
                           smoothing: float = 1.0) -> "ActivationModel":
        """Estimate weights from observed expert-selection counts (L, I).

        Activation probabilities are monotone in the weights (Eq. 14), so
        smoothed empirical frequencies are a consistent plug-in.
        """
        counts = np.asarray(counts, dtype=np.float64) + smoothing
        return ActivationModel(weights=counts / counts.sum(axis=1, keepdims=True),
                               top_k=top_k)
