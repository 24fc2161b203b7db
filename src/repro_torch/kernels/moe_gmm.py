"""Grouped expert matmul (the MoE FFN hot loop): CUDA kernel + plain version.

Computes ``out[e] = x[e] @ w[e]`` for capacity-padded expert buckets
x: (E, C, K), w: (E, K, N) -> (E, C, N) in ``x.dtype``, with f32
accumulation.  Counterpart of ``repro.kernels.moe_gmm.gmm``; the kernel
is ``csrc/moe_gmm.cu`` (its header says what bounds it and why it is
built as it is).

``gmm`` runs the plain version for CPU tensors and the kernel for CUDA
tensors; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset (ops.py)


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 accumulation, result in x.dtype."""
    out = torch.einsum("eck,ekn->ecn", x.float(), w.float())
    return out.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}; the kernel "
                         "needs both on one CUDA device")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"gmm: dtypes {x.dtype}/{w.dtype}; the kernel takes "
                        "float32 or bfloat16, the same for x and w")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm: shape mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")


def _library():
    lib = build.load("moe_gmm")
    if lib.repro_gmm.argtypes is None:
        lib.repro_gmm_workspace.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.repro_gmm_workspace.restype = ctypes.c_longlong
        lib.repro_gmm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.repro_gmm.restype = ctypes.c_int
    return lib


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul (E,C,K) x (E,K,N) -> (E,C,N) in x.dtype."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gmm_plain(x, w)
    _check(x, w)
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    code = DTYPE_CODES[x.dtype]
    # f32 scratch for the decode-shaped path's K-split partial sums.
    n_ws = lib.repro_gmm_workspace(e, c, k, n, code, w.data_ptr())
    ws = torch.empty((max(n_ws, 1),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_gmm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            ws.data_ptr(), n_ws, e, c, k, n, code, stream)
    build.check(err, "gmm")
    launches += 1
    return out
