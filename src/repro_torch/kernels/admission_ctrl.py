"""The admission controller's AIMD / PID cell over control bins: CUDA + plain.

For every cell (f, p, g), over the control bins k in order, with
``w = win[k, f, p]`` the windowed maximum of the critical-path backlog
estimate qhat that bin k closes, the cell of ``repro.traffic.admission``
(its module docstring pins the law) steps the admission probability:

* AIMD: ``admit * decrease`` (floored at ``admit_min``) when
  ``ttft0[p, g] + w > ttft_target[f]`` or ``tpot0[p] + w >
  tpot_target[f]``, else ``admit + increase`` (capped at 1) (the anchors
  may also be per entry, ``ttft0[f, p, g]`` and ``tpot0[f, p]``: the joint
  control plane's schedule row);
* PID: the normalized headroom ``err`` (an infinite target drops its
  term), the integral clamped at +-``_PID_WINDUP``, ``delta = kp * err +
  ki * integ + kd * (err - prev)``, ``admit + gain[p] * delta`` clamped
  to [``admit_min``, 1].

``out[k]`` is the admission probability in effect after control bin k.
This is the serial half of the reference's ``adm_scan`` (a ``lax.scan``
over every time bin, ``repro/traffic/queueing.py:589``); the rest of it
is ``backlog_scan`` and ``admission_window``.  All of it is float32, each
operation rounded on its own in the reference's order: the plain loop and
the kernel (``csrc/admission_ctrl.cu``, no FMA contraction) agree bit for
bit (NaN payloads aside).

The kernel is a chunk-parallel scan that stays exact: one warp a cell,
each lane a chunk of ``ctrl_chunk(n_ctrl)`` control bins run from both
ends of the state's bracket; from the bin where the two runs meet they
are the true trajectory, and only the bins before it are re-run from the
chunk's exact start, which a walk over the chunks in order supplies (the
note at the head of ``csrc/admission_ctrl.cu`` gives the argument).  The
bracket needs ``AdmissionConfig``'s ranges: ``0 < decrease < 1``,
``increase > 0`` and ``0 < admit_min <= 1``; the wrapper refuses others.

``admission_ctrl`` runs the plain loop for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

#: Anti-windup clamp on the PID integral (the reference's ``_PID_WINDUP``).
PID_WINDUP = 10.0
LANES = 32            # chunks of one cell's control bins: a warp, a lane each

launches = 0          # kernel launches since the last reset (ops.py)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def admission_ctrl_plain(win, ttft0, tpot0, admit0, ttft_target,
                         tpot_target, *, increase, decrease, admit_min,
                         pid=None) -> torch.Tensor:
    """Plain PyTorch version: the cell as a loop over control bins.

    Shapes as :func:`admission_ctrl`; ``pid`` is None (AIMD) or a dict of
    ``kp``, ``ki``, ``kd`` (floats) and ``gain`` ((P,) float32).
    """
    dev, f32 = win.device, torch.float32

    def scalar(x):
        return torch.tensor(_f32(x), dtype=f32, device=dev)

    tt = ttft_target[:, None, None]                          # (F, 1, 1)
    tp = tpot_target[:, None]                                # (F, 1)
    if ttft0.dim() == 2:                                     # shared anchors
        ttft0, tpot0 = ttft0[None], tpot0[None]
    one, inf = scalar(1.0), scalar(float("inf"))
    amin = scalar(admit_min)
    admit = admit0.clone()
    out = torch.empty((win.shape[0],) + admit0.shape, dtype=f32, device=dev)
    if pid is None:
        inc, dec = scalar(increase), scalar(decrease)
    else:
        kp, ki, kd = scalar(pid["kp"]), scalar(pid["ki"]), scalar(pid["kd"])
        gain = pid["gain"][None, :, None]                    # (1, P, 1)
        windup = scalar(PID_WINDUP)
        integ = torch.zeros_like(admit0)
        prev = torch.zeros_like(admit0)
        tt_fin, tp_fin = torch.isfinite(tt), torch.isfinite(tp)
    for k in range(win.shape[0]):
        w = win[k]                                           # (F, P)
        if pid is None:
            over = ((ttft0 + w[..., None]) > tt) \
                | ((tpot0 + w) > tp)[..., None]
            admit = torch.where(over, torch.maximum(admit * dec, amin),
                                torch.minimum(admit + inc, one))
        else:
            h_t = torch.where(tt_fin, (tt - (ttft0 + w[..., None])) / tt,
                              inf)
            h_p = torch.where(tp_fin, (tp - (tpot0 + w)) / tp,
                              inf)[..., None]
            err = torch.minimum(h_t, h_p)
            integ = torch.minimum(torch.maximum(integ + err, -windup), windup)
            delta = kp * err + ki * integ + kd * (err - prev)
            prev = err
            admit = torch.minimum(torch.maximum(admit + gain * delta, amin),
                                  one)
        out[k] = admit
    return out


def ctrl_chunk(n_ctrl: int) -> int:
    """Control bins of one chunk: the kernel cuts each cell's ``n_ctrl``
    bins into ``LANES`` chunks of this many (the last ones shorter or
    empty)."""
    return max(1, -(-n_ctrl // LANES))


def _library():
    lib = build.load("admission_ctrl")
    if lib.repro_admission_ctrl.argtypes is None:
        lib.repro_admission_ctrl.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int64] * 9 + [ctypes.c_int] + [ctypes.c_float] * 6 + [
            ctypes.c_void_p]
        lib.repro_admission_ctrl.restype = ctypes.c_int
    return lib


def admission_ctrl(win: torch.Tensor, ttft0: torch.Tensor,
                   tpot0: torch.Tensor, admit0: torch.Tensor,
                   ttft_target: torch.Tensor, tpot_target: torch.Tensor, *,
                   increase: float, decrease: float, admit_min: float,
                   pid: dict | None = None,
                   coalescence: torch.Tensor | None = None) -> torch.Tensor:
    """Admission probability after each control bin, (n_ctrl, F, P, G).

    On the card the result is a view of an (F, P, G, n_ctrl) buffer (each
    cell's control bins contiguous, as the kernel writes them), and
    ``win`` is read in place with any strides (``admission_window``
    gives it k-contiguous); the CPU's result is contiguous.

    Args (all float32 tensors on one device):
        win: (n_ctrl, F, P) windowed maximum of qhat per control bin.
        ttft0: (P, G) zero-load TTFT anchors per (plan, gateway), or
            (F, P, G) per entry.
        tpot0: (P,) zero-load TPOT anchors, or (F, P) per entry.
        admit0: (F, P, G) admission probabilities before the first bin.
        ttft_target, tpot_target: (F,) margin-scaled targets (+inf
            disables a term).
        increase, decrease, admit_min: AIMD constants (rounded to f32;
            ``0 < decrease < 1``, ``increase > 0``, ``0 < admit_min <=
            1``).
        pid: None for AIMD, or ``kp``/``ki``/``kd`` floats and ``gain``
            (P,) float32 for the PID cell.
        coalescence: CUDA only: an int32 (F * P * G, ``LANES``) tensor
            that receives, for each cell and chunk, the control bins the
            chunk's two bracket runs took to meet (-1: they never did, or
            the chunk is empty).
    """
    global launches
    tensors = [win, ttft0, tpot0, admit0, ttft_target, tpot_target]
    if pid is not None:
        tensors.append(pid["gain"])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("admission_ctrl: every tensor must be float32")
    n_ctrl, n_f, n_p = win.shape
    n_g = ttft0.shape[-1]
    per_entry = ttft0.dim() == 3
    lead = (n_f, n_p) if per_entry else (n_p,)
    if ttft0.shape != lead + (n_g,) or tpot0.shape != lead \
            or admit0.shape != (n_f, n_p, n_g) \
            or ttft_target.shape != (n_f,) or tpot_target.shape != (n_f,) \
            or (pid is not None and pid["gain"].shape != (n_p,)):
        raise ValueError("admission_ctrl: shapes do not agree with win "
                         f"{tuple(win.shape)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("admission_ctrl: tensors on more than one device")
    if not (0.0 < _f32(decrease) < 1.0 and _f32(increase) > 0.0
            and 0.0 < _f32(admit_min) <= 1.0):
        raise ValueError("admission_ctrl: takes 0 < decrease < 1, increase "
                         "> 0 and 0 < admit_min <= 1 (AdmissionConfig's "
                         f"ranges); got {decrease}, {increase}, {admit_min}")
    kw = dict(increase=increase, decrease=decrease, admit_min=admit_min,
              pid=pid)
    if win.device.type == "cpu" and coalescence is None:
        return admission_ctrl_plain(*tensors[:6], **kw)
    if win.device.type != "cuda":
        raise ValueError(f"admission_ctrl: tensors on {win.device}; the "
                         "kernel (and its coalescence report) needs a CUDA "
                         "device")
    n_cells = n_f * n_p * n_g
    if coalescence is not None and (
            coalescence.shape != (n_cells, LANES)
            or coalescence.dtype != torch.int32
            or coalescence.device != win.device
            or not coalescence.is_contiguous()):
        raise ValueError(f"admission_ctrl: coalescence must be a contiguous "
                         f"int32 ({n_cells}, {LANES}) tensor on {win.device}")
    out = torch.empty((n_f, n_p, n_g, n_ctrl), dtype=torch.float32,
                      device=win.device)
    if out.numel() == 0:
        return out.permute(3, 0, 1, 2)
    tensors = [tensors[0]] + [t.contiguous() for t in tensors[1:]]
    gain = tensors[6].data_ptr() if pid is not None else None
    p = pid or {}
    lib = _library()
    with torch.cuda.device(win.device):
        err = lib.repro_admission_ctrl(
            *(t.data_ptr() for t in tensors[:6]), gain, out.data_ptr(),
            coalescence.data_ptr() if coalescence is not None else None,
            n_ctrl, n_f, n_p, n_g, *win.stride(),
            n_p * n_g if per_entry else 0, n_p if per_entry else 0,
            ctrl_chunk(n_ctrl),
            _f32(increase),
            _f32(decrease), _f32(admit_min), _f32(p.get("kp", 0.0)),
            _f32(p.get("ki", 0.0)), _f32(p.get("kd", 0.0)),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "admission_ctrl")
    launches += 1
    return out.permute(3, 0, 1, 2)
