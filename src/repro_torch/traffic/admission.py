"""Latency-target adaptive admission control for the fleet simulator.

Counterpart of ``repro.traffic.admission``, whose module docstring pins
the AIMD and PID laws.  ``AdmissionConfig``, ``control_bin_flags`` and
``resolve_admission`` are host numpy, the reference's arithmetic.

``admission_queue_scan`` takes the reference's arguments and returns its
outputs, but is not a scan over every time bin.  The backlog recursion
never reads the controller's state, so it is computed apart from it:

1. **wait** is :func:`~repro_torch.kernels.backlog_scan.backlog_scan` of
   the work plane (float32, bitwise the reference's recursion);
2. **win**, the maximum over each control window (the bins up to and
   including the bin that ``ctrl`` marks) of qhat, the critical-path
   estimate the cell reads after each bin (the backlog after the bin
   gathered at its gateway and expert stations):
   :func:`~repro_torch.kernels.admission_window.admission_window`, one
   pass over the wait trace on the card, :func:`qhat_trace` and a
   ``scatter_reduce`` on the CPU;
3. the cell itself, serial over the control bins only:
   :func:`~repro_torch.kernels.admission_ctrl.admission_ctrl`;
4. the **admit** trace repeats the value in effect over each window (bin
   t carries the value before bin t's own update).

The fused fleet fixed point (``queueing._fleet_fixed_point``) runs the
same steps 2-4 through :func:`controller_states`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.admission_ctrl import admission_ctrl
from ..kernels.admission_window import (  # noqa: F401 (qhat_trace: public)
    admission_window, control_segments, qhat_trace)
from ..kernels.backlog_scan import backlog_scan
from .batching import batched_effective_work


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Latency-target admission controller parameters (the reference's
    fields, defaults and validation; see ``repro.traffic.admission``).

    Attributes:
        policy: ``"aimd"``, ``"pid"`` or ``"static"`` (the controller is
            bypassed; the ``kv_slots`` cap applies).
        ttft_target_s: TTFT target the controller defends.
        tpot_target_s: TPOT target; +inf disables the TPOT term.
        interval_s: Control interval (quantized to time bins).
        increase: AIMD additive increase per clean interval.
        decrease: AIMD multiplicative factor on a breaching interval.
        admit_min: Admission-probability floor.
        target_margin: Fraction of the target the predictor is held to.
        reference_quantile: Quantile of the zero-load TTFT/TPOT used as
            the predictor's anchors.
        max_retries: Gateway retries a rejected request may make.
        retry_backoff_s: Delay between consecutive attempts.
        kp: PID proportional gain.
        ki: PID integral gain (the integral clamped at
            ``kernels.admission_ctrl.PID_WINDUP``).
        kd: PID derivative gain.
        gain_scale: Optional per-plan multipliers on the PID output.
    """

    policy: str = "aimd"
    ttft_target_s: float = 30.0
    tpot_target_s: float = float("inf")
    interval_s: float = 0.5
    increase: float = 0.1
    decrease: float = 0.6
    admit_min: float = 0.05
    target_margin: float = 0.85
    reference_quantile: float = 0.99
    max_retries: int = 2
    retry_backoff_s: float = 1.0
    kp: float = 0.4
    ki: float = 0.05
    kd: float = 0.0
    gain_scale: tuple | None = None

    def __post_init__(self):
        """Validate the law's parameters."""
        if self.policy not in ("aimd", "pid", "static"):
            raise ValueError(f"unknown admission policy {self.policy!r}")
        if self.policy == "pid":
            if self.kp <= 0.0:
                raise ValueError("kp must be positive")
            if self.ki < 0.0 or self.kd < 0.0:
                raise ValueError("ki/kd must be non-negative")
            if self.gain_scale is not None \
                    and any(g <= 0.0 for g in self.gain_scale):
                raise ValueError("gain_scale entries must be positive")
        if not 0.0 < self.decrease < 1.0:
            raise ValueError("decrease must be in (0, 1)")
        if self.increase <= 0.0:
            raise ValueError("increase must be positive")
        if not 0.0 < self.admit_min <= 1.0:
            raise ValueError("admit_min must be in (0, 1]")
        if not 0.0 < self.target_margin <= 1.0:
            raise ValueError("target_margin must be in (0, 1]")
        if not 0.0 <= self.reference_quantile <= 1.0:
            raise ValueError("reference_quantile must be in [0, 1]")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def n_attempts(self) -> int:
        """Total ingress attempts per request (first try + retries)."""
        return self.max_retries + 1


def controller_states(wait: torch.Tensor, work_last: torch.Tensor,
                      cap: float, dt: float, gw_rows: torch.Tensor,
                      exp_rows: torch.Tensor, bin_map: torch.Tensor,
                      seg: torch.Tensor, n_ctrl: int, ttft0: torch.Tensor,
                      tpot0: torch.Tensor, admit0: torch.Tensor,
                      ttft_target: torch.Tensor, tpot_target: torch.Tensor,
                      *, increase: float, decrease: float, admit_min: float,
                      pid: dict | None = None) -> torch.Tensor:
    """(n_ctrl + 1, F, P, G) float32 controller states: ``admit0``, then
    the admission probability after each control bin's update.

    ``wait`` (T, F, C) float32 wait trace through ``n_ctrl`` as
    :func:`~repro_torch.kernels.admission_window.admission_window` takes
    them (``seg`` from :func:`control_segments` of the control flags);
    the rest as :func:`~repro_torch.kernels.admission_ctrl.admission_ctrl`
    takes them.  Bin t runs under ``states[seg[t]]`` and leaves
    ``states[seg[t] + ctrl[t]]`` behind it.
    """
    win = admission_window(wait, work_last, cap, dt, gw_rows, exp_rows,
                           bin_map, seg, n_ctrl)
    out = admission_ctrl(win, ttft0, tpot0, admit0, ttft_target,
                         tpot_target, increase=increase, decrease=decrease,
                         admit_min=admit_min, pid=pid)
    return torch.cat([admit0[None], out])


def admission_queue_scan(work, cap, dt, ttft0, tpot0, ctrl, gw_idx, exp_idx,
                         admit0, ttft_target, tpot_target, increase,
                         decrease, admit_min, batching=None, pid=None):
    """Fleet backlog scan with the AIMD (or PID) controller.

    The reference's arguments and outputs (tensors on one device, the
    scan in float32 as the fleet's always is): ``work`` (P, S, T),
    ``cap`` and ``dt`` scalars, ``ttft0`` (P, G), ``tpot0`` (P,),
    ``ctrl`` (T,) bool, ``gw_idx`` (T, P, L) and ``exp_idx`` (T, P, L*I)
    stations per bin, ``admit0`` (P, G), the margin-scaled scalar targets,
    the AIMD constants and ``pid`` (``kp``/``ki``/``kd`` and ``gain``
    (P,)) or None.  ``batching``: None, or the continuous-batching planes
    ``work_dec`` and ``cnt_win`` (P, S, T) (decode work and the windowed
    occupancy) with ``table`` and ``bcap`` (the padded speedup table and
    batch cap): :func:`~.batching.batched_effective_work` rewrites
    ``work`` in the inputs' dtype before the scan, as the reference's
    does.

    Returns:
        (wait, dropped, admit): wait/dropped (P, S, T) float32 exactly as
        the plain fleet scan; admit (P, G, T), the admission probability
        in effect during each bin.
    """
    dev = work.device
    if batching is not None:
        planes = [torch.as_tensor(batching[k], device=dev)
                  for k in ("work_dec", "cnt_win")]
        if any(t.shape != work.shape for t in planes):
            raise ValueError(
                "admission_queue_scan: the batching planes must be shaped "
                f"like work {tuple(work.shape)}, not "
                f"{[tuple(t.shape) for t in planes]}")
        work, _ = batched_effective_work(
            work, *planes, torch.as_tensor(batching["table"], device=dev),
            float(batching["bcap"]))
    f32 = torch.float32
    n_p, n_s, n_bins = work.shape
    w32 = work.to(f32)
    cap32 = torch.tensor(float(cap), dtype=f32, device=dev)
    dt32 = torch.tensor(float(dt), dtype=f32, device=dev)
    wait_t = backlog_scan(w32.permute(2, 0, 1).reshape(n_bins, n_p * n_s),
                          float(cap32), float(dt32))          # (T, P*S)
    wait = wait_t.reshape(n_bins, n_p, n_s).permute(1, 2, 0)
    dropped = torch.clamp_min((wait + w32) - cap32, 0.0)
    base = torch.arange(n_p, device=dev)[None, :, None] * n_s
    gw_rows = base + torch.as_tensor(gw_idx, device=dev).to(torch.int64)
    exp_rows = base + torch.as_tensor(exp_idx, device=dev).to(torch.int64)
    seg, n_ctrl = control_segments(torch.as_tensor(ctrl, device=dev))
    pid_t = None
    if pid is not None:
        pid_t = dict(kp=float(pid["kp"]), ki=float(pid["ki"]),
                     kd=float(pid["kd"]),
                     gain=torch.as_tensor(pid["gain"], device=dev).to(f32))

    def target(x):
        return torch.full((1,), float(x), dtype=f32, device=dev)
    admit = controller_states(
        wait_t[:, None], w32[..., -1].reshape(1, -1), float(cap32),
        float(dt32), gw_rows, exp_rows, torch.arange(n_bins, device=dev),
        seg, n_ctrl, torch.as_tensor(ttft0, device=dev).to(f32),
        torch.as_tensor(tpot0, device=dev).to(f32),
        torch.as_tensor(admit0, device=dev).to(f32)[None],
        target(ttft_target), target(tpot_target), increase=increase,
        decrease=decrease, admit_min=admit_min, pid=pid_t)[seg]  # (T,1,P,G)
    return wait, dropped, admit[:, 0].permute(1, 2, 0)


def control_bin_flags(n_bins: int, dt_s: float, interval_s: float
                      ) -> np.ndarray:
    """(T,) bool — True on bins that close a control interval.

    The interval is quantized to whole bins (minimum one bin, i.e. a
    controller update every ``max(1, round(interval_s / dt_s))`` bins).
    """
    every = max(1, int(round(interval_s / dt_s)))
    t = np.arange(n_bins)
    return (t + 1) % every == 0


def resolve_admission(admit: np.ndarray, attempt_bin: np.ndarray,
                      attempt_station: np.ndarray, feasible: np.ndarray,
                      u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Resolve each request's first admitted ingress attempt.

    Attempt a of request r is admitted iff its uniform draw clears the
    admission probability in effect at the attempt's (gateway, bin) —
    common random numbers: the same ``u`` is used for every plan.

    Args:
        admit: (P, G, T) admission-probability trace.
        attempt_bin: (A, R) time bin of each attempt.
        attempt_station: (A, R) gateway of each attempt.
        feasible: (A, P, R) attempt reaches a visible, routable ingress.
        u: (A, R) per-(attempt, request) uniform draws in [0, 1).

    Returns:
        (choice, shed): choice is (P, R) — the index of the first
        admitted attempt (0 = no retry needed; undefined where shed);
        shed is (P, R) bool — every attempt rejected or infeasible.
    """
    adm = admit[:, attempt_station, attempt_bin]                # (P, A, R)
    ok = (u[None, :, :] < adm) & np.moveaxis(feasible, 1, 0)    # (P, A, R)
    shed = ~ok.any(axis=1)
    return ok.argmax(axis=1), shed
