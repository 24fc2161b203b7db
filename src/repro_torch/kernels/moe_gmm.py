"""Grouped expert matmul (the MoE FFN hot loop): CUDA kernel + plain version.

Computes ``out[e] = x[e] @ w[e]`` for capacity-padded expert buckets
x: (E, C, K), w: (E, K, N) -> (E, C, N) in ``x.dtype``, with f32
accumulation.  Counterpart of ``repro.kernels.moe_gmm.gmm``; the kernel
is ``csrc/moe_gmm.cu`` (its header says what bounds it and why it is
built as it is).

``gmm`` runs the plain version for CPU tensors and the kernel for CUDA
tensors; on a CUDA tensor it launches the kernel or raises.  The kernel
has two paths, picked by ``gmm_path`` from shapes and alignment alone
before the launch: ``"wgmma"`` (bf16 tensor-core tiles fed by TMA) and
``"fma"`` (CUDA-core tiles, for f32 and for bf16 shapes TMA cannot take).

``gmm`` is differentiable (the reference's ``gmm`` has no VJP; its
training path runs einsums).  When grad mode is on and x or w requires a
grad, the call goes through ``GmmFunction``, whose backward runs both
products through the same kernel on transposed operands:
``dx = gmm(dy, wᵀ)`` with wᵀ (E, N, K) and ``dw = gmm(xᵀ, dy)`` with xᵀ
(E, K, C).  The transposes are ``.contiguous()`` copies (a K-major
operand path that reads them in place is later work); on CPU tensors the
same products run ``gmm_plain``.  Otherwise (serve, ``torch.no_grad``)
``gmm`` launches directly, with no autograd node.  ``launches`` and
``path_launches`` count every launch, the backward's included.

On ``meta`` tensors (the dry run, ``launch/dryrun.py``) a product checks
shapes and dtypes and returns an empty ``meta`` result: it launches and
computes nothing.  Every product, wherever it runs, reports its flops
and bytes (its bound's arithmetic) to an active dry-run count
(``counting.kernel``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import counting
from . import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"fma": 0, "wgmma": 1}
BLOCK_N = 128         # columns n a block of the wgmma path covers
K_STEP = 64           # K per pipeline stage of the wgmma path
IN_FLIGHT = 6_000_000  # bytes the narrow tiles keep requested (gmm_depth)

launches = 0          # kernel launches since the last reset (ops.py)
path_launches = {"wgmma": 0, "fma": 0}   # the same launches, by path


def gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 accumulation, result in x.dtype."""
    out = torch.einsum("eck,ekn->ecn", x.float(), w.float())
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _tma_rows(k: int, n: int, dtype: torch.dtype) -> bool:
    """bf16 rows TMA can read: K and N multiples of 8 (16-byte strides)."""
    return dtype == torch.bfloat16 and k > 0 and k % 8 == 0 and n % 8 == 0


def gmm_path(k: int, n: int, dtype: torch.dtype, ptrs) -> str:
    """The kernel path for these arguments: ``"wgmma"`` or ``"fma"``.

    TMA reads bf16 rows whose stride is a multiple of 16 bytes (K and N
    multiples of 8) from 16-byte aligned base addresses (``ptrs``: the
    data pointers of x, w and out); everything else, and f32, takes the
    CUDA-core tiles.  The shape test is cached; only the alignment test runs
    on every call.
    """
    if _tma_rows(k, n, dtype) and not any(p % 16 for p in ptrs):
        return "wgmma"
    return "fma"


@functools.lru_cache(maxsize=None)
def gmm_depth(e: int, c: int, n: int) -> int:
    """Stages of the wgmma path's ring kept in flight for these shapes.

    Wide buckets (C > 64) are operations-bound and keep the whole ring
    (0).  Narrow ones are bytes-bound: a depth that keeps about IN_FLIGHT
    bytes of w and x requested across the card, at least 2; deeper rings
    measured slower on the H100 (PERF.md, PR 14).
    """
    if c > 64:
        return 0
    blocks = e * -(-n // BLOCK_N)
    stage = (BLOCK_N + -(-c // 8) * 8) * K_STEP * 2      # w and x bytes
    return max(2, -(-IN_FLIGHT // (blocks * stage)))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}; the kernel "
                         "needs both on one CUDA device")
    _check_operands(x, w)


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
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
        lib.repro_gmm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p])
        lib.repro_gmm.restype = ctypes.c_int
    return lib


def product_cost(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int]:
    """(flops, bytes) of one product: 2 E C K N, and x, w and out once."""
    n = w.shape[-1]
    rows = math.prod(x.shape[:-1])
    return 2 * rows * x.shape[-1] * n, \
        (x.numel() + w.numel() + rows * n) * x.element_size()


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One product: ``gmm_plain`` for CPU tensors, an empty result for
    ``meta`` ones, else one kernel launch; reported to ``counting``."""
    cost = product_cost(x, w) if counting.active() else (0, 0)
    with counting.kernel("gmm", *cost):
        if x.device.type == "cpu" and w.device.type == "cpu":
            return gmm_plain(x, w)
        if x.device.type == "meta" and w.device.type == "meta":
            _check_operands(x, w)
            return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
        return _launch(x, w)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    _check(x, w)
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr())
    path = gmm_path(k, n, x.dtype, ptrs)
    depth = gmm_depth(e, c, n) if path == "wgmma" else 0
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_gmm(*ptrs, e, c, k, n, DTYPE_CODES[x.dtype],
                            PATH_CODES[path], depth, stream)
    build.check(err, f"gmm ({path})")
    launches += 1
    path_launches[path] += 1
    return out


class GmmFunction(torch.autograd.Function):
    """``gmm`` with a backward through the same kernel (module docstring)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = _product(x.transpose(1, 2).contiguous(), dy)
        return dx, dw


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul (E,C,K) x (E,K,N) -> (E,C,N) in x.dtype;
    differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GmmFunction.apply(x, w)
    return _product(x, w)
