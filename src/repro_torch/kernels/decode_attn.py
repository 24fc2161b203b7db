"""GQA flash-decode attention over a KV cache: CUDA kernel + plain version.

One new token per sequence attends over its cache row (paper Sec. III-B,
the gateway satellite's per-token self-attention).  Inputs, as in
``repro.kernels.decode_attn.decode_attention``:

    q:   (B, Hkv, G, hd)   query heads grouped under their KV head
    k/v: (B, Hkv, S, hd)   cache; kv index > pos[b] is masked
    pos: (B,) int32        current position, in [0, S)

The kernel (``csrc/decode_attn.cu``) takes k and v through their strides,
so a transposed view of the model's (B, S, Hkv, hd) cache is read in
place; only the last axis must be contiguous.  It splits S over blocks
(``decode_splits``) and merges the splits in the same launch, through a
workspace and a per-(b, h) counter (``_counters``).

``decode_attention_partial`` is the kernel's partial mode, for a rank
that holds one block of the cache's sequence (context parallelism): the
f32 output normalized over the rows the block leaves visible, and the
f32 log-sum-exp of their scores, per (b, query head), which the ranks
combine (``models.attention``).  A row whose window is empty (pos < 0)
gives out = 0 and lse = -inf.  ``decode_attention`` and
``decode_attention_partial`` run the plain version for CPU tensors and
the kernel for CUDA tensors;
on a CUDA tensor it launches the kernel or raises.  On ``meta`` tensors
(the dry run) it checks shapes and dtypes and returns an empty ``meta``
result, launching and computing nothing; wherever it runs, a call
reports its flops and bytes to an active dry-run count
(``counting.kernel``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import counting
from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

BLOCKS_PER_SM = 8     # blocks decode_splits aims at on every SM
MIN_CHUNK = 64        # rows of a split: at least, and a multiple of

launches = 0          # kernel launches since the last reset (ops.py)
mode_launches = {"full": 0, "partial": 0}   # the same launches, by mode
_COUNTERS: dict[int, torch.Tensor] = {}   # per device: the merge counters


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 scores and softmax, result in q.dtype."""
    hd = q.shape[-1]
    s = k.shape[2]
    sco = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * hd ** -0.5
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        <= pos.to(q.device)[:, None, None, None]
    sco = torch.where(mask, sco, torch.full_like(sco, NEG_INF))
    p = torch.softmax(sco, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.to(q.dtype)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, pos: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the partial mode: (out (B, Hkv, G, hd),
    lse (B, Hkv, G)), both f32; an empty window gives out = 0 and
    lse = -inf (not the uniform average a softmax of masked scores
    would)."""
    hd = q.shape[-1]
    s = k.shape[2]
    sco = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * hd ** -0.5
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        <= pos.to(q.device)[:, None, None, None]
    sco = torch.where(mask, sco, torch.full_like(sco, float("-inf")))
    lse = torch.logsumexp(sco, dim=-1)
    p = torch.exp(sco - torch.where(torch.isfinite(lse), lse,
                                    torch.zeros_like(lse))[..., None])
    return torch.einsum("bhgs,bhsd->bhgd", p, v.float()), lse


@functools.lru_cache(maxsize=None)
def decode_splits(b: int, hkv: int, s: int, sms: int) -> tuple[int, int]:
    """(n_split, chunk): the splits of the cache length ``s`` over blocks.

    Enough splits that b * hkv * n_split blocks put BLOCKS_PER_SM on each
    of ``sms`` SMs, each split ``chunk`` rows, a multiple of MIN_CHUNK (so
    a split starts on a tile boundary of every tile size the kernel
    uses); one split when ``s`` is under MIN_CHUNK rows.  Reads shapes
    only: ``pos`` stays on the device.
    """
    want = -(-BLOCKS_PER_SM * sms // (b * hkv))
    n_split = max(1, min(want, s // MIN_CHUNK))
    rows = -(-s // n_split)
    chunk = -(-rows // MIN_CHUNK) * MIN_CHUNK
    return -(-s // chunk), chunk


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` merge counters on ``device``, zeroed once; every
    launch leaves them zero again (so launches on one device must not
    overlap: one stream at a time)."""
    have = _COUNTERS.get(device.index)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = have
    return have


def _check(q, k, v, pos) -> None:
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, pos)):
        raise ValueError("decode_attention: q, k, v and pos must lie on one "
                         "CUDA device")
    _check_operands(q, k, v, pos)
    esize = q.element_size()
    row_bytes = [n * esize for n in (q.shape[-1], *k.stride()[:3],
                                     *v.stride()[:3])]
    if any(n % 16 for n in (*row_bytes, k.data_ptr(), v.data_ptr())):
        raise ValueError("decode_attention: the kernel copies K and V rows "
                         "16 bytes at a time; head_dim, the strides of k and "
                         "v and their data pointers must be multiples of 16 "
                         "bytes")


def _check_operands(q, k, v, pos) -> None:
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        "the same for q, k and v")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: pos must be int32, not {pos.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, hkv, _, hd = q.shape
    if k.shape[0] != b or k.shape[1] != hkv or k.shape[3] != hd \
            or pos.shape != (b,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)} / pos {tuple(pos.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and pos.is_contiguous()
            and k.stride(-1) == 1 and v.stride(-1) == 1):
        raise ValueError("decode_attention: q and pos must be contiguous, "
                         "and k, v contiguous along head_dim")


def _launcher():
    lib = build.load("decode_attn")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def attention_cost(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int]:
    """(flops, bytes) of one call over every cache row: its bound's
    arithmetic (4 Hkv G hd a row; q read and out written, each row's K
    and V read once, pos) with the rows of the whole cache, B x S, since
    the rows up to ``pos`` are the data's (a count on ``meta`` has none)."""
    b, hkv, g, hd = q.shape
    rows = b * k.shape[2]
    esize = q.element_size()
    return 4 * hkv * g * hd * rows, \
        2 * q.numel() * esize + 2 * hkv * rows * hd * esize + 4 * b


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Returns (B, Hkv, G, hd) attention output in q.dtype."""
    cost = attention_cost(q, k) if counting.active() else (0, 0)
    with counting.kernel("decode_attention", *cost):
        if all(t.device.type == "cpu" for t in (q, k, v, pos)):
            return decode_attention_plain(q, k, v, pos)
        if all(t.device.type == "meta" for t in (q, k, v, pos)):
            _check_operands(q, k, v, pos)
            return torch.empty_like(q)
        return _launch(q, k, v, pos)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, pos: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial mode (module docstring): (out (B, Hkv, G, hd) f32,
    lse (B, Hkv, G) f32) over the rows of ``k``/``v`` up to ``pos``."""
    cost = (0, 0)
    if counting.active():               # out and lse written in f32
        flops, nbytes = attention_cost(q, k)
        cost = (flops, nbytes + q.numel() * (4 - q.element_size())
                + 4 * q.numel() // q.shape[-1])
    with counting.kernel("decode_attention", *cost):
        if all(t.device.type == "cpu" for t in (q, k, v, pos)):
            return decode_attention_partial_plain(q, k, v, pos)
        if all(t.device.type == "meta" for t in (q, k, v, pos)):
            _check_operands(q, k, v, pos)
            return (torch.empty(q.shape, dtype=torch.float32, device="meta"),
                    torch.empty(q.shape[:-1], dtype=torch.float32,
                                device="meta"))
        return _launch(q, k, v, pos, partial=True)


def _launch(q, k, v, pos, partial: bool = False):
    global launches
    _check(q, k, v, pos)
    b, hkv, g, hd = q.shape
    s = k.shape[2]
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    else:
        out, lse = torch.empty_like(q), None
    if out.numel() == 0:
        return (out, lse) if partial else out
    fn = _launcher()
    gp = 1 if g == 1 else 4            # query heads a block takes
    units = b * hkv * -(-g // gp)
    with torch.cuda.device(q.device):
        n_split, chunk = decode_splits(b, hkv, s, build.sm_count(q.device.index))
        ws = counters = None
        if n_split > 1:
            ws = torch.empty(units * n_split * (2 * gp + gp * hd),
                             dtype=torch.float32, device=q.device)
            counters = _counters(q.device, units)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if partial else None,
                 ws.data_ptr() if ws is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 b, hkv, g, s, hd, gp, n_split, chunk,
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 DTYPE_CODES[q.dtype], stream)
    build.check(err, "decode_attention")
    launches += 1
    mode_launches["partial" if partial else "full"] += 1
    return (out, lse) if partial else out
