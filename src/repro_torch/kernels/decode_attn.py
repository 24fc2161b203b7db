"""GQA flash-decode attention over a KV cache: CUDA kernel + plain version.

One new token per sequence attends over its cache row (paper Sec. III-B,
the gateway satellite's per-token self-attention).  Inputs, as in
``repro.kernels.decode_attn.decode_attention``:

    q:   (B, Hkv, G, hd)   query heads grouped under their KV head
    k/v: (B, Hkv, S, hd)   cache; kv index > pos[b] is masked
    pos: (B,) int32        current position, in [0, S)

The kernel (``csrc/decode_attn.cu``) takes k and v through their strides,
so a transposed view of the model's (B, S, Hkv, hd) cache is read in
place; only the last axis must be contiguous.  ``decode_attention`` runs
the plain version for CPU tensors and the kernel for CUDA tensors; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset (ops.py)


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


def _launcher():
    lib = build.load("decode_attn")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), b, hkv, g, s, hd,
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 DTYPE_CODES[q.dtype], stream)
    build.check(err, "decode_attention")
    launches += 1
    return out
