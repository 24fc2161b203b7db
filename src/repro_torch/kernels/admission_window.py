"""The admission controller's window maxima of qhat: CUDA + plain.

For every bin t, entry f and plan p, the critical-path backlog estimate
the controller reads after bin t is

    qhat[t, f, p] = sum_l after[t, f, gw[s, p, l]]
                    + sum_l max_i after[t, f, ex[s, p, l * I + i]]

with ``after[t]`` the backlog after bin t (the wait of bin t + 1; after
the last bin one more step of the recursion, ``max(min(wait + work, cap)
- dt, 0)`` in float32 in that order), ``s`` the bin's topology slot and
each sum over layers in index order.  The station tables are shared by
the entries (``gw[s, p, l]``) or per entry (``gw[s, f, p, l]``: the joint
control plane's schedule row, whose decided plan differs by entry).  ``win[k, f, p]`` is the maximum of
qhat over control window k: the bins with ``seg[t] == k``, ``seg =
cumsum(ctrl) - ctrl`` (:func:`control_segments`); bins after the last
control bin belong to no window.  This is the qhat/window half of the
reference's ``adm_scan`` (``repro/traffic/queueing.py:589``; not a Pallas
kernel).

``admission_window_plain`` is :func:`qhat_trace` (batched gathers of the
wait trace) followed by one ``scatter_reduce``; ``admission_window`` runs
it for CPU tensors and ``csrc/admission_window.cu`` for CUDA tensors (it
launches the kernel or raises): one pass over the wait plane, each bin's
row staged in shared memory, the sums in the same order, so the two agree
bit for bit.  The wait trace is finite and non-negative
(``backlog_scan``'s premise), so the maxima need no order.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

#: Elements of one gather of :func:`qhat_trace` (the expert gather of the
#: paper's world is T * F * P * L * I, about 0.5 G at F = 4): the bins are
#: taken in chunks that keep each gather under this.
QHAT_CHUNK_ELEMS = 1 << 24
TILE_BYTES = 72 * 1024    # staged rows a block of the kernel aims at
SMEM_MAX = 232_448        # shared memory one block may have on an H100

launches = 0              # kernel launches since the last reset (ops.py)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (XLA's CPU reduction order),
    so the sum is the same on every device."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def qhat_trace(wait: torch.Tensor, work_last: torch.Tensor, cap: torch.Tensor,
               dt: torch.Tensor, gw_rows: torch.Tensor, exp_rows: torch.Tensor,
               bin_map: torch.Tensor) -> torch.Tensor:
    """(T, F, P) float32 critical-path backlog estimate after each bin.

    The backlog after bin t is the wait of bin t + 1; after the last bin
    it is one more step of the recursion, ``max(min(wait + work, cap) -
    dt, 0)`` in float32 in that order.

    Args:
        wait: (T, F, C) float32 wait trace (the backlog before each bin).
        work_last: (F, C) float32 work of the last bin.
        cap, dt: float32 scalar tensors, the scan's cap and bin width.
        gw_rows: (NB, P, L) int64 column of each plan's gateway per
            layer, or (NB, F, P, L) per entry.
        exp_rows: (NB, P, L * I) int64 column of each (layer, expert), or
            (NB, F, P, L * I).
        bin_map: (T,) int64 row of ``gw_rows``/``exp_rows`` per bin.

    The gateway chain is summed over layers in index order; the expert
    term takes each layer's maximum over I, summed the same way; then
    gateway + expert, as the reference's cell adds them.
    """
    n_bins, n_f, _ = wait.shape
    last = torch.clamp_min(torch.minimum(wait[-1] + work_last, cap) - dt, 0.0)
    n_p, n_li = exp_rows.shape[-2], exp_rows.shape[-1]
    out = torch.empty((n_bins, n_f, n_p), dtype=torch.float32,
                      device=wait.device)
    step = max(1, QHAT_CHUNK_ELEMS // max(1, n_f * n_p * n_li))
    for t0 in range(0, n_bins, step):
        t1 = min(n_bins, t0 + step)
        after = wait[t0 + 1:t1 + 1]
        if t1 == n_bins:
            after = torch.cat([after, last[None]])
        rows = bin_map[t0:t1]
        out[t0:t1] = qhat_of(after, gw_rows[rows], exp_rows[rows])
    return out


def qhat_of(after: torch.Tensor, gw_rows: torch.Tensor,
            exp_rows: torch.Tensor) -> torch.Tensor:
    """(n, F, P) qhat of n bins from the backlog after each, ``after``
    (n, F, C), and each bin's gateway columns (n, P, L) and (layer,
    expert) columns (n, P, L * I), or per entry (n, F, P, L) and (n, F,
    P, L * I), as :func:`qhat_trace` sums them."""
    n, n_f, _ = after.shape
    n_p, n_layers = gw_rows.shape[-2], gw_rows.shape[-1]
    if gw_rows.dim() == 3:
        gw_rows, exp_rows = gw_rows[:, None], exp_rows[:, None]
    t_idx = torch.arange(n, device=after.device)[:, None, None, None]
    f_idx = torch.arange(n_f, device=after.device)[None, :, None, None]
    gw = after[t_idx, f_idx, gw_rows]                          # (n,F,P,L)
    ex = after[t_idx, f_idx, exp_rows]                         # (n,F,P,LI)
    ex = ex.reshape(n, n_f, n_p, n_layers, -1).amax(dim=4)
    return _seq_sum(gw) + _seq_sum(ex)


def control_segments(ctrl: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(seg, n_ctrl) of the (T,) control flags: ``seg[t]`` (int64) is the
    number of control bins before bin t, the window bin t belongs to;
    ``n_ctrl`` the number of windows (bins with ``seg == n_ctrl`` come
    after the last control bin and belong to none)."""
    ctrl = ctrl.to(torch.int64)
    return torch.cumsum(ctrl, 0) - ctrl, int(ctrl.sum())


def admission_window_plain(wait, work_last, cap: float, dt: float, gw_rows,
                           exp_rows, bin_map, seg, n_ctrl: int
                           ) -> torch.Tensor:
    """Plain PyTorch version: :func:`qhat_trace`, then the maximum over
    each window in one ``scatter_reduce`` (qhat is never negative, so
    windows that start from 0 give the same maxima)."""
    f32, dev = torch.float32, wait.device
    qhat = qhat_trace(wait, work_last, torch.tensor(cap, dtype=f32, device=dev),
                      torch.tensor(dt, dtype=f32, device=dev), gw_rows,
                      exp_rows, bin_map)
    win = torch.zeros((n_ctrl + 1,) + qhat.shape[1:], dtype=f32, device=dev)
    idx = seg.to(torch.int64)[:, None, None].expand_as(qhat)
    win.scatter_reduce_(0, idx, qhat, "amax")
    return win[:n_ctrl]


def window_tile(n_f: int, n_c: int, n_p: int, n_l: int,
                n_i: int, n_e: int = 1) -> tuple[int, int]:
    """(bins a block, row stride in floats) of the kernel for a (T, F, C)
    plane and P plans of L layers x I experts: rows of whole 16-byte
    words padded by one (copied 16 bytes at a time), others to an odd
    stride (the lanes of a warp read one column of consecutive rows); a
    bin also holds its F * P * L gateway terms and expert maxima, its slot
    and its window; a block holds one slot's n_e * P * L * (1 + I)
    stations (n_e: 1 for shared station tables, F for per-entry ones).
    As many bins as fit TILE_BYTES."""
    n_fc = n_f * n_c
    stride = n_fc + 4 if n_fc % 4 == 0 else n_fc | 1
    per_bin = 4 * (stride + 2 * n_f * n_p * n_l + 2)
    fixed = 4 * n_e * n_p * n_l * (1 + n_i)
    tile = max(1, (TILE_BYTES - fixed) // per_bin)
    if tile * per_bin + fixed > SMEM_MAX:
        raise ValueError(f"admission_window: a bin of {n_f} x {n_c} backlog "
                         f"columns and {n_p} x {n_l} x {n_i} stations exceeds "
                         "a block's shared memory")
    return tile, stride


def _library():
    lib = build.load("admission_window")
    if lib.repro_admission_window.argtypes is None:
        lib.repro_admission_window.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64] * 3 + [ctypes.c_int] * 9 + [
            ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.repro_admission_window.restype = ctypes.c_int
    return lib


def admission_window(wait: torch.Tensor, work_last: torch.Tensor, cap: float,
                     dt: float, gw_rows: torch.Tensor, exp_rows: torch.Tensor,
                     bin_map: torch.Tensor, seg: torch.Tensor,
                     n_ctrl: int) -> torch.Tensor:
    """(n_ctrl, F, P) float32 window maxima of qhat.

    Args (tensors on one device):
        wait: (T, F, C) float32 wait trace, finite and non-negative.
        work_last: (F, C) float32 work of the last bin (any strides).
        cap, dt: the scan's cap and bin width (rounded to float32).
        gw_rows: (NS, P, L) integer column of each plan's gateway per
            layer, per slot; or (NS, F, P, L), per slot and entry.
        exp_rows: (NS, P, L * I) integer column of each (layer, expert),
            or (NS, F, P, L * I).
        bin_map: (T,) integer slot of each bin (row of the tables).
        seg: (T,) integer window of each bin, ``n_ctrl`` for none
            (:func:`control_segments`).
        n_ctrl: the number of windows.

    The kernel takes the integer tables as int32 (others are cast on
    each call; the fleet keeps int32 copies on the card).  On the card
    the result is a view of an (F, P, n_ctrl) buffer, each (f, p)'s
    windows contiguous, the layout ``admission_ctrl`` reads fastest; the
    CPU's is contiguous.
    """
    global launches
    if wait.dtype != torch.float32 or wait.dim() != 3 \
            or work_last.dtype != torch.float32:
        raise TypeError("admission_window: wait (T, F, C) and work_last "
                        "must be float32")
    n_bins, n_f, n_c = wait.shape
    per_entry = gw_rows.dim() == 4
    n_e = n_f if per_entry else 1
    n_s, n_p, n_l = gw_rows.shape[0], gw_rows.shape[-2], gw_rows.shape[-1]
    lead = (n_s, n_e, n_p) if per_entry else (n_s, n_p)
    if work_last.shape != (n_f, n_c) or gw_rows.shape[:-1] != lead \
            or exp_rows.shape[:-1] != lead \
            or n_l == 0 or exp_rows.shape[-1] % n_l \
            or exp_rows.shape[-1] == 0 or bin_map.shape != (n_bins,) \
            or seg.shape != (n_bins,):
        raise ValueError("admission_window: shapes do not agree with wait "
                         f"{tuple(wait.shape)}")
    tensors = (wait, work_last, gw_rows, exp_rows, bin_map, seg)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("admission_window: tensors on more than one device")
    if wait.device.type == "cpu":
        return admission_window_plain(wait, work_last, cap, dt, gw_rows,
                                      exp_rows, bin_map, seg, n_ctrl)
    if wait.device.type != "cuda":
        raise ValueError(f"admission_window: tensors on {wait.device}; the "
                         "kernel needs a CUDA device")
    win = torch.empty((n_f, n_p, n_ctrl), dtype=torch.float32,
                      device=wait.device)
    if win.numel() == 0:
        return win.permute(2, 0, 1)
    n_i = exp_rows.shape[-1] // n_l
    tile, stride = window_tile(n_f, n_c, n_p, n_l, n_i, n_e)
    wait = wait.contiguous()
    ints = [t.to(torch.int32).contiguous()
            for t in (gw_rows, exp_rows, bin_map, seg)]
    lib = _library()
    with torch.cuda.device(wait.device):
        err = lib.repro_admission_window(
            wait.data_ptr(), work_last.data_ptr(),
            *(t.data_ptr() for t in ints), win.data_ptr(), n_bins,
            work_last.stride(0), work_last.stride(1), n_f, n_c, n_p, n_l,
            n_i, n_e, n_ctrl, tile, stride, float(np.float32(cap)),
            float(np.float32(dt)), torch.cuda.current_stream().cuda_stream)
    build.check(err, "admission_window")
    launches += 1
    return win.permute(2, 0, 1)
