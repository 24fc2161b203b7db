"""Continuous decode batching for the fleet queue (counterpart of
``repro.traffic.batching``, whose module docstring pins the law).

Alongside the offered-work plane ``work`` the fleet deposits a
decode-work plane ``work_dec`` (the decode-side subset of the deposits)
and an occupancy-count plane ``cnt`` (decode token visits per (row,
bin)).  Per (row, bin)

    ``B_eff = clip(window_sum(cnt), 1, B_cap)``,
    ``B_cap = min(b_max, kv_slots_per_sat)``,

``s(B_eff)`` interpolates a monotone speedup table with ``s(1) = 1``,
and the backlog scan runs on the effective work

    ``work_eff = work + work_dec * (1 / s(B_eff) - 1)``.

``b_max = 1`` gives ``s == 1.0`` exactly, so ``work_eff == work`` bit
for bit; a larger cap gives a pointwise larger ``s`` and so pointwise
smaller effective work and waits.  Since ``s >= 1`` and the work deposit
is a superset of the decode deposit summed in the same order (``work >=
work_dec`` cell by cell), the effective work is finite and non-negative:
the premise of ``kernels/csrc/backlog_scan.cu``.

``BatchingConfig``, :func:`windowed_counts`, :func:`batch_speedup_at`
and :func:`effective_work_np` are host numpy, the reference's
arithmetic.  :func:`batched_effective_work` and
:func:`windowed_counts_torch` are the tensor forms on the fleet's
device: one eager operation at a time, in the reference's order, so no
multiply and add contract to a fused multiply-add and the law is bitwise
``effective_work_np`` at a window of one bin.  Over a wider window the
sum is a ``torch.cumsum`` difference as in the reference's fused path,
whose summation order differs by device (and from ``np.cumsum`` on the
card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Continuous decode-batching parameters (the reference's fields,
    defaults and validation).

    Attributes:
        b_max: Largest decode batch a satellite may form per time bin
            (``b_max=1`` is bitwise FIFO).
        kv_slots_per_sat: KV-cache slots one satellite can hold; bounds
            the admissible batch (``B_cap = min(b_max, kv_slots)``); 0 =
            unbounded by KV.
        window_s: Occupancy window, seconds (inclusive of the deposit's
            own bin); 0 uses exactly one bin.
        speedup: Optional explicit per-batch speedup table ``(s(1), ...,
            s(n))`` overriding the service model's (clamped monotone and
            >= 1, extended flat past its end).
    """

    b_max: int = 8
    kv_slots_per_sat: int = 0
    window_s: float = 0.0
    speedup: tuple | None = None

    def __post_init__(self):
        """Validate the batching parameters."""
        if self.b_max < 1:
            raise ValueError("b_max must be >= 1")
        if self.kv_slots_per_sat < 0:
            raise ValueError("kv_slots_per_sat must be >= 0")
        if self.window_s < 0.0:
            raise ValueError("window_s must be >= 0")
        if self.speedup is not None:
            sp = np.asarray(self.speedup, dtype=np.float64)
            if sp.ndim != 1 or sp.size < 1:
                raise ValueError("speedup must be a non-empty 1-D table")
            if not np.all(np.isfinite(sp)) or np.any(sp <= 0.0):
                raise ValueError("speedup entries must be finite and > 0")

    @property
    def b_cap(self) -> int:
        """The admissible batch bound: ``min(b_max, kv_slots_per_sat)``
        (unbounded KV keeps ``b_max``)."""
        if self.kv_slots_per_sat > 0:
            return int(min(self.b_max, self.kv_slots_per_sat))
        return int(self.b_max)

    def window_bins(self, dt_s: float) -> int:
        """Occupancy window in whole time bins (>= 1)."""
        return max(1, int(round(self.window_s / dt_s)))

    def resolve_table(self, service_model=None,
                      ctx_len: int = 1024) -> np.ndarray:
        """The ``(b_cap + 2,)`` float64 interpolation table: ``table[b]``
        the speedup at batch b for b in 1..b_cap, ``table[0] = 1`` and a
        flat extension at ``table[b_cap + 1]``; clamped monotone
        non-decreasing with ``table[1] = 1`` exactly."""
        cap = self.b_cap
        if self.speedup is not None:
            s = np.asarray(self.speedup, dtype=np.float64)
        elif service_model is not None:
            s = np.asarray(service_model.batch_speedup(cap, ctx_len),
                           dtype=np.float64)
        else:
            s = np.ones(cap, dtype=np.float64)
        if s.size < cap:
            s = np.concatenate([s, np.full(cap - s.size, s[-1])])
        s = np.maximum.accumulate(np.maximum(s[:cap], 1.0))
        s[0] = 1.0
        return np.concatenate([[1.0], s, [s[-1]]])


def windowed_counts(cnt: np.ndarray, window_bins: int) -> np.ndarray:
    """Causal inclusive window sum of ``cnt`` along the last (time) axis:
    ``out[..., t] = sum(cnt[..., t - w + 1 : t + 1])`` for window w."""
    w = int(window_bins)
    if w <= 1:
        return cnt
    cs = np.cumsum(cnt, axis=-1)
    out = cs.copy()
    out[..., w:] -= cs[..., :-w]
    return out


def batch_speedup_at(cnt_win, table: np.ndarray, b_cap: float):
    """(s, B_eff) at a windowed occupancy count (numpy arrays):
    ``B_eff = clip(cnt_win, 1, b_cap)`` and ``s`` the linear
    interpolation of ``table`` at ``B_eff`` (``b_cap = 1`` gives
    ``s == 1.0`` exactly)."""
    table = np.asarray(table, dtype=np.float64)
    beff = np.clip(cnt_win, 1.0, float(b_cap))
    idx = np.clip(np.floor(beff).astype(np.int64), 0, table.size - 2)
    frac = beff - idx
    s = table[idx] * (1.0 - frac) + table[idx + 1] * frac
    return s, beff


def effective_work_np(work: np.ndarray, work_dec: np.ndarray,
                      cnt: np.ndarray, table: np.ndarray, b_cap: float,
                      window_bins: int = 1):
    """The batching law in host form: ``(work_eff, b_eff)``, both shaped
    like ``work`` (..., T), with ``work_eff = work + work_dec * (1 /
    s(B_eff) - 1)`` over the ``window_bins`` window sum of ``cnt``."""
    s, beff = batch_speedup_at(windowed_counts(cnt, window_bins),
                               table, b_cap)
    return work + work_dec * (1.0 / s - 1.0), beff


def batched_effective_work(work: torch.Tensor, work_dec: torch.Tensor,
                           cnt_win: torch.Tensor, table: torch.Tensor,
                           b_cap):
    """The batching law in tensor form, the window sum already applied
    (``cnt_win``): ``(work_eff, b_eff)`` in the inputs' dtype, each
    operation as :func:`effective_work_np` orders it.  ``table`` is the
    padded speedup table (:meth:`BatchingConfig.resolve_table`) on the
    inputs' device; ``b_cap`` a number or a scalar tensor."""
    beff = torch.clamp(cnt_win, 1.0, float(b_cap))
    idx = torch.clamp(torch.floor(beff).to(torch.int64), 0,
                      table.shape[0] - 2)
    frac = beff - idx
    s = table[idx] * (1.0 - frac) + table[idx + 1] * frac
    return work + work_dec * (1.0 / s - 1.0), beff


def windowed_counts_torch(cnt: torch.Tensor, window_bins: int) -> torch.Tensor:
    """:func:`windowed_counts` in tensor form (time on the last axis), as
    the reference's fused path takes it: a cumulative sum less the same
    sum ``window_bins`` bins earlier."""
    w = int(window_bins)
    if w <= 1:
        return cnt
    cs = torch.cumsum(cnt, dim=-1)
    shifted = torch.cat(
        [torch.zeros(cnt.shape[:-1] + (min(w, cnt.shape[-1]),),
                     dtype=cnt.dtype, device=cnt.device), cs[..., :-w]],
        dim=-1)
    return cs - shifted
