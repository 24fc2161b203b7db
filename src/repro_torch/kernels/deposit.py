"""Scatter-add work deposit (the fleet simulator's hot bin): CUDA + plain.

Computes ``out[rows[i], cols[i]] += vals[i]`` into a dense
``(n_rows, n_cols)`` float64 plane, each cell summing its values one
after the other in table order from 0.0 — bit for bit what the
reference's f64 path computes (``repro.kernels.ref.deposit_ref``, the
inline ``.at[flat].add`` of the fused fleet fixed point).  Counterpart of
``repro.kernels.deposit.deposit``, whose TPU kernel is an f32 one-hot
matmul; the kernel here is ``csrc/deposit.cu`` (its header says what
bounds it and why it is built as it is).

``deposit`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0          # kernel launches since the last reset (ops.py)


def deposit_plain(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                  n_rows: int, n_cols: int) -> torch.Tensor:
    """Plain PyTorch version, a port of ``deposit_segments``.

    One sort of the packed key ``flat << shift | i`` orders the triples by
    target cell and, within a cell, by table position; each cell's run is
    then summed in order, one rank per pass (pass r adds the r-th value of
    every run, so a pass touches each cell at most once and the sum order
    is the table order on any device).
    """
    n = rows.numel()
    dev = vals.device
    out = torch.zeros(n_rows * n_cols, dtype=vals.dtype, device=dev)
    if n == 0:
        return out.view(n_rows, n_cols)
    flat = rows.to(torch.int64) * n_cols + cols.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    shift = max(1, (n - 1).bit_length())
    if n_rows * n_cols <= (1 << (63 - shift)):
        packed = torch.sort((flat << shift) | idx).values
        ids, order = packed >> shift, packed & ((1 << shift) - 1)
    else:
        ids, order = torch.sort(flat, stable=True)
    v = vals[order]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = ids[1:] != ids[:-1]
    start = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                         dim=0).values
    rank = idx - start                       # position within the cell's run
    by_rank = torch.sort(rank, stable=True).indices
    counts = torch.bincount(rank).tolist()
    pos = 0
    for cnt in counts:
        sel = by_rank[pos:pos + cnt]
        pos += cnt
        cell = ids[sel]
        out[cell] = out[cell] + v[sel]
    return out.view(n_rows, n_cols)


def _check(rows, cols, vals, n_rows, n_cols) -> None:
    if vals.device.type != "cuda" or rows.device != vals.device \
            or cols.device != vals.device:
        raise ValueError(f"deposit: rows on {rows.device}, cols on "
                         f"{cols.device}, vals on {vals.device}; the kernel "
                         "needs all three on one CUDA device")
    if vals.dtype != torch.float64:
        raise TypeError(f"deposit: vals are {vals.dtype}; the kernel "
                        "accumulates float64")
    if rows.dim() != 1 or rows.shape != cols.shape \
            or rows.shape != vals.shape:
        raise ValueError(f"deposit: shape mismatch {tuple(rows.shape)} / "
                         f"{tuple(cols.shape)} / {tuple(vals.shape)}")
    if n_rows <= 0 or n_cols <= 0:
        raise ValueError(f"deposit: a {n_rows} x {n_cols} plane; the kernel "
                         "takes at least one row and one column")


def _library():
    lib = build.load("deposit")
    if lib.repro_deposit.argtypes is None:
        lib.repro_deposit.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_longlong] * 2
                                      + [ctypes.c_void_p])
        lib.repro_deposit.restype = ctypes.c_int
    return lib


def deposit(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
            n_rows: int, n_cols: int,
            row_ptr: torch.Tensor | None = None) -> torch.Tensor:
    """Dense scatter-add ``out[rows[i], cols[i]] += vals[i]``, (n_rows, n_cols).

    ``row_ptr`` (required for CUDA tensors, unused on the CPU) says how
    the table is grouped by row: row r owns entries
    [row_ptr[r], row_ptr[r+1]) in table order, and entries from
    ``row_ptr[-1]`` on are zero-valued padding the kernel does not read
    (adding +0.0 changes no sum that starts at +0.0).  The fleet's chunk
    table comes grouped (``FleetSim.chunk_table``); the kernel reads
    ``cols`` and ``vals`` through it and never reads ``rows``.
    """
    global launches
    if vals.device.type == "cpu" and rows.device.type == "cpu" \
            and cols.device.type == "cpu":
        return deposit_plain(rows, cols, vals, n_rows, n_cols)
    _check(rows, cols, vals, n_rows, n_cols)
    cols = cols.to(torch.int64)
    if row_ptr is None or row_ptr.shape != (n_rows + 1,) \
            or row_ptr.dtype != torch.int64 or row_ptr.device != vals.device:
        raise ValueError("deposit: row_ptr must be int64 (n_rows + 1,) on "
                         "the device of vals")
    cols, vals = cols.contiguous(), vals.contiguous()
    out = torch.empty((n_rows, n_cols), dtype=torch.float64,
                      device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_deposit(row_ptr.data_ptr(), cols.data_ptr(),
                                vals.data_ptr(), out.data_ptr(), n_rows,
                                n_cols, stream)
    build.check(err, "deposit")
    launches += 1
    return out
