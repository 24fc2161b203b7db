"""Scatter-add work deposit (the fleet simulator's hot bin): CUDA + plain.

Computes ``out[rows[i], cols[i]] += vals[i]`` into a dense
``(n_rows, n_cols)`` float64 plane, each cell summing its values one
after the other in table order from 0.0 — bit for bit what the
reference's f64 path computes (``repro.kernels.ref.deposit_ref``, the
inline ``.at[flat].add`` of the fused fleet fixed point).  Counterpart of
``repro.kernels.deposit.deposit``, whose TPU kernel is an f32 one-hot
matmul; the kernel here is ``csrc/deposit.cu`` (its header says what
bounds it and why it is built as it is): a pass that buckets each row's
triples stably by tile of ``TILE`` bins, then persistent warps that take
(row, tile) tasks, the longest buckets first, sum each bucket in shared
memory and write each tile once.
``deposit_segments`` is the reference's row-bucketed sort deposit of the
same name, which the plain version implements.

``deposit`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

TILE = 512            # bins a bucket covers (kTile in csrc/deposit.cu)
MAX_TILES = 7168      # tiles a row may have (kMaxTiles): the bucket pass's
                      # per-(warp, tile) counters fill at most 227 KB
WIDE_TILES = 3584     # tiles a row may have for 16 bucket warps (else 8)
launches = 0          # deposit calls that launched the kernel (ops.py);
                      # each call is 2 kernel launches, bucket and accumulate


def deposit_tiles(n_cols: int) -> int:
    """Tiles of ``TILE`` bins a row of ``n_cols`` bins is cut into."""
    return -(-n_cols // TILE)


def bucket_warps(n_cols: int) -> int:
    """Warps of the bucket launch's block (one block a row): 16, or 8
    where 16 warps' int32 counters per tile would not fit 227 KB."""
    return 16 if deposit_tiles(n_cols) <= WIDE_TILES else 8


def scratch_bytes(n_entries: int, n_rows: int, n_cols: int) -> int:
    """Scratch of one kernel call: 16 bytes of task counters and long-bucket
    count, a 10-byte bucket entry (f64 value, u16 bin in its tile) per
    table entry, padding included, and per (row, tile) an int32 bucket
    end and an int32 slot of the long-bucket list."""
    return 16 + 10 * n_entries + 8 * n_rows * deposit_tiles(n_cols)


def deposit_plain(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                  n_rows: int, n_cols: int) -> torch.Tensor:
    """Plain PyTorch version: ``deposit_segments`` with its packed key."""
    return deposit_segments(rows, cols, vals, n_rows, n_cols)


def deposit_segments(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, n_rows: int, n_cols: int,
                     bucketed: bool = True) -> torch.Tensor:
    """Row-bucketed sort deposit, the reference's ``deposit_segments``.

    With ``bucketed``, one sort of the packed key ``flat << shift | i``
    orders the triples by target cell and, within a cell, by table
    position (a stable sort of ``flat`` with its positions when the key
    would overflow int64).  Without it the reference sums the unsorted ids
    by a scatter in update order; here the stable sort stands in for that
    scatter, which runs in order on the CPU only.  Either way each cell's
    run is then summed in order, one rank per pass (pass r adds the r-th
    value of every run, so a pass touches each cell at most once and the
    sum order is the table order on any device): the result is bitwise
    the reference's for both values of ``bucketed``.
    """
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError(f"shape mismatch {tuple(rows.shape)} / "
                         f"{tuple(cols.shape)} / {tuple(vals.shape)}")
    n = rows.numel()
    dev = vals.device
    out = torch.zeros(n_rows * n_cols, dtype=vals.dtype, device=dev)
    if n == 0:
        return out.view(n_rows, n_cols)
    flat = rows.to(torch.int64) * n_cols + cols.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    shift = max(1, (n - 1).bit_length())
    if bucketed and n_rows * n_cols <= (1 << (63 - shift)):
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
        if (lib.repro_deposit_tile(), lib.repro_deposit_max_tiles()) \
                != (TILE, MAX_TILES):
            raise RuntimeError("deposit: csrc/deposit.cu and deposit.py "
                               "disagree on the tile geometry")
        lib.repro_deposit.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_longlong] * 3
                                      + [ctypes.c_int, ctypes.c_void_p])
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
    ``cols`` and ``vals`` through it and never reads ``rows``.  It takes
    at most ``MAX_TILES * TILE`` bins a row and fewer than 2**31 entries
    and (row, tile) pairs, and uses ``scratch_bytes`` of scratch; one
    call is one count in ``launches`` (two CUDA kernel launches after a
    16-byte memset).
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
    n = cols.numel()
    if deposit_tiles(n_cols) > MAX_TILES or n >= 2 ** 31 \
            or n_rows * deposit_tiles(n_cols) >= 2 ** 31:
        raise ValueError(f"deposit: {n} entries into {n_rows} x {n_cols}; "
                         f"the kernel takes at most {MAX_TILES * TILE} bins "
                         f"a row, fewer than 2**31 entries and fewer than "
                         f"2**31 (row, {TILE}-bin tile) pairs")
    cols, vals, row_ptr = cols.contiguous(), vals.contiguous(), \
        row_ptr.contiguous()
    out = torch.empty((n_rows, n_cols), dtype=torch.float64,
                      device=vals.device)
    scratch = torch.empty(scratch_bytes(n, n_rows, n_cols), dtype=torch.uint8,
                          device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_deposit(row_ptr.data_ptr(), cols.data_ptr(),
                                vals.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), n, n_rows, n_cols,
                                bucket_warps(n_cols), stream)
    build.check(err, "deposit")
    launches += 1
    return out
