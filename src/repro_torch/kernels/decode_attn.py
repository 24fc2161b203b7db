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
workspace and a per-(b, h) counter (``_counters``).  ``decode_attention``
runs the plain version for CPU tensors and the kernel for CUDA tensors;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

BLOCKS_PER_SM = 8     # blocks decode_splits aims at on every SM
MIN_CHUNK = 64        # rows of a split: at least, and a multiple of

launches = 0          # kernel launches since the last reset (ops.py)
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
    esize = q.element_size()
    row_bytes = [n * esize for n in (hd, *k.stride()[:3], *v.stride()[:3])]
    if any(n % 16 for n in (*row_bytes, k.data_ptr(), v.data_ptr())):
        raise ValueError("decode_attention: the kernel copies K and V rows "
                         "16 bytes at a time; head_dim, the strides of k and "
                         "v and their data pointers must be multiples of 16 "
                         "bytes")


def _launcher():
    lib = build.load("decode_attn")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Returns (B, Hkv, G, hd) attention output in q.dtype."""
    global launches
    if all(t.device.type == "cpu" for t in (q, k, v, pos)):
        return decode_attention_plain(q, k, v, pos)
    _check(q, k, v, pos)
    b, hkv, g, hd = q.shape
    s = k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
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
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 b, hkv, g, s, hd, gp, n_split, chunk,
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 DTYPE_CODES[q.dtype], stream)
    build.check(err, "decode_attention")
    launches += 1
    return out
