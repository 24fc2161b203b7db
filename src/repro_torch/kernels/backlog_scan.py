"""Backlog recursion of the fleet queue over time bins: CUDA + plain.

For every column c of a (T, C) float32 work plane, from b = 0:

    wait[t, c] = b;   b = max(min(b + work[t, c], cap) - dt, 0)

so ``wait[t]`` is the backlog an arrival in bin t finds.  Counterpart of
the ``lax.scan`` in ``repro.traffic.queueing`` (``fleet_scan`` of the
fused fixed point, ``_fleet_queue_scan`` of the host path), in the same
float32.  Not a Pallas kernel in the reference; on the port's path an
eager loop would cost ~4 launches a bin, so it is ``csrc/backlog_scan.cu``.

``backlog_scan`` runs the plain loop for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises.  Work is
finite and non-negative (seconds of service), so the kernel's fminf/fmaxf
and the loop's minimum/maximum agree bit for bit.  The kernel cuts T into
chunks of ``scan_chunk`` bins that run in parallel and stay exact: each
chunk is run from 0 and from the largest backlog a step can leave, and
from the bin where the two runs meet it is the true trajectory; the bins
before it are filled in from the previous chunk's exact end (the note at
the head of ``csrc/backlog_scan.cu`` gives the argument).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

TILE_COLS = 32        # columns a block of the kernel owns
MAX_CHUNK = 4096      # bins of a chunk: at most,
MIN_CHUNK = 1024      # at least (ceil((cap - dt) / dt) = 199 bins drain a
                      # full buffer at QueueConfig()'s cap 10 s, dt 0.05 s)
WARPS_PER_SM = 8      # blocks (one warp each) scan_chunk aims at per SM

launches = 0          # kernel launches since the last reset (ops.py)
_STATE: dict[int, list] = {}   # per device: [end words, ticket, epoch]


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


def scan_chunk(n_bins: int, n_cols: int, sms: int) -> int:
    """Bins of one chunk: the longest power of two from MAX_CHUNK down to
    MIN_CHUNK that still gives WARPS_PER_SM blocks on each of ``sms`` SMs
    (longer chunks re-run fewer bins before the runs meet)."""
    tiles = -(-n_cols // TILE_COLS)
    chunk = MAX_CHUNK
    while chunk > MIN_CHUNK and tiles * -(-n_bins // chunk) < WARPS_PER_SM * sms:
        chunk //= 2
    return chunk


def _state(device: torch.device, n_ends: int):
    """(end words, ticket, epoch) for one launch on ``device``: the 64-bit
    words in which the kernel publishes each chunk's exact end per column
    (zeroed once, grown as needed), its block ticket, and a fresh epoch
    (the tag that marks a word as written by this launch)."""
    st = _STATE.get(device.index)
    if st is None or st[0].numel() < n_ends or st[2] >= 2 ** 31:
        st = [torch.zeros(max(n_ends, 1 << 16), dtype=torch.int64,
                          device=device),
              torch.zeros(1, dtype=torch.int32, device=device), 0]
        _STATE[device.index] = st
    st[2] += 1
    return st[0], st[1], st[2]


def _library():
    lib = build.load("backlog_scan")
    if lib.repro_backlog_scan.argtypes is None:
        lib.repro_backlog_scan.argtypes = [
            ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint,
            ctypes.c_void_p]
        lib.repro_backlog_scan.restype = ctypes.c_int
    return lib


def backlog_scan(work: torch.Tensor, cap: float, dt: float, *,
                 coalescence: torch.Tensor | None = None) -> torch.Tensor:
    """Wait trace (T, C) float32 of the (T, C) float32 ``work``.

    The kernel reads ``work`` column-major, bins contiguous: the fleet
    passes a transposed view of its (F, rows, T) plane, read in place.
    Other layouts are copied to it first.  ``wait`` is contiguous.

    ``coalescence`` (CUDA only): an int32 (ceil(T / chunk), C) tensor,
    chunk = ``scan_chunk(T, C, build.sm_count(device))``, that receives
    for each chunk and column the bins its two bracketing runs took to
    meet (-1: they never did).

    Each launch tags its chunk ends with a fresh epoch, so calls on one
    device must not overlap (one stream at a time) and a CUDA graph
    capturing a call would replay a stale epoch.
    """
    global launches
    if work.dtype != torch.float32 or work.dim() != 2:
        raise TypeError(f"backlog_scan: work is {work.dtype} "
                        f"{tuple(work.shape)}; it takes float32 (T, C)")
    if work.device.type == "cpu" and coalescence is None:
        return backlog_scan_plain(work, cap, dt)
    if work.device.type != "cuda":
        raise ValueError(f"backlog_scan: work on {work.device}; the kernel "
                         "(and its coalescence report) needs a CUDA device")
    n_bins, n_cols = work.shape
    wait = torch.empty((n_bins, n_cols), dtype=torch.float32, device=work.device)
    if work.numel() == 0:
        return wait
    if work.stride(0) != 1 and n_bins > 1:
        work = work.T.contiguous().T
    lib = _library()
    with torch.cuda.device(work.device):
        chunk = scan_chunk(n_bins, n_cols, build.sm_count(work.device.index))
        n_chunks = -(-n_bins // chunk)
        if coalescence is not None and (
                coalescence.shape != (n_chunks, n_cols)
                or coalescence.dtype != torch.int32
                or coalescence.device != work.device
                or not coalescence.is_contiguous()):
            raise ValueError(f"backlog_scan: coalescence must be a contiguous "
                             f"int32 ({n_chunks}, {n_cols}) tensor on "
                             f"{work.device}")
        ends, ticket, epoch = _state(work.device, n_chunks * n_cols)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_backlog_scan(
            work.data_ptr(), wait.data_ptr(), ends.data_ptr(),
            ticket.data_ptr(),
            coalescence.data_ptr() if coalescence is not None else None,
            n_bins, n_cols, work.stride(0), work.stride(1), chunk,
            float(cap), float(dt), epoch, stream)
    build.check(err, "backlog_scan")
    launches += 1
    return wait
