"""Backlog recursion of the fleet queue over time bins: CUDA + plain.

For every column c of a time-major (T, C) float32 work plane, from b = 0:

    wait[t, c] = b;   b = max(min(b + work[t, c], cap) - dt, 0)

so ``wait[t]`` is the backlog an arrival in bin t finds.  Counterpart of
the ``lax.scan`` in ``repro.traffic.queueing`` (``fleet_scan`` of the
fused fixed point, ``_fleet_queue_scan`` of the host path), in the same
float32.  Not a Pallas kernel in the reference; on the port's path an
eager loop would cost ~4 launches a bin, so it is ``csrc/backlog_scan.cu``.

``backlog_scan`` runs the plain loop for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises.  Work is
finite and non-negative (seconds of service), so the kernel's fminf/fmaxf
and the loop's minimum/maximum agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0          # kernel launches since the last reset (ops.py)


def backlog_scan_plain(work: torch.Tensor, cap: float,
                       dt: float) -> torch.Tensor:
    """Plain PyTorch version: the recursion as a loop over bins (float32)."""
    cap_t = torch.tensor(cap, dtype=torch.float32, device=work.device)
    dt_t = torch.tensor(dt, dtype=torch.float32, device=work.device)
    zero = torch.zeros((), dtype=torch.float32, device=work.device)
    wait = torch.empty_like(work)
    b = torch.zeros(work.shape[1:], dtype=torch.float32, device=work.device)
    for t in range(work.shape[0]):
        wait[t] = b
        b = torch.maximum(torch.minimum(b + work[t], cap_t) - dt_t, zero)
    return wait


def _library():
    lib = build.load("backlog_scan")
    if lib.repro_backlog_scan.argtypes is None:
        lib.repro_backlog_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p]
        lib.repro_backlog_scan.restype = ctypes.c_int
    return lib


def backlog_scan(work: torch.Tensor, cap: float, dt: float) -> torch.Tensor:
    """Wait trace (T, C) float32 of the time-major (T, C) float32 ``work``."""
    global launches
    if work.dtype != torch.float32 or work.dim() != 2:
        raise TypeError(f"backlog_scan: work is {work.dtype} "
                        f"{tuple(work.shape)}; it takes float32 (T, C)")
    if work.device.type == "cpu":
        return backlog_scan_plain(work, cap, dt)
    if work.device.type != "cuda":
        raise ValueError(f"backlog_scan: work on {work.device}; the kernel "
                         "needs a CUDA device")
    work = work.contiguous()
    wait = torch.empty_like(work)
    if work.numel() == 0:
        return wait
    lib = _library()
    with torch.cuda.device(work.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_backlog_scan(work.data_ptr(), wait.data_ptr(),
                                     work.shape[0], work.shape[1],
                                     float(cap), float(dt), stream)
    build.check(err, "backlog_scan")
    launches += 1
    return wait
