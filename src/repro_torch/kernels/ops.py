"""Public entry points of the port's kernels.

Each op dispatches on where its tensors lie: CPU tensors go to the plain
PyTorch version, CUDA tensors to the hand-written kernel (which launches
or raises; there is no fallback).  ``launch_counts`` reads the kernels'
launch counters, so a run can show that its main path went through them.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from . import admission_ctrl as _ctrl
from . import admission_window as _window
from . import backlog_scan as _scan
from . import decode_attn, deposit as _deposit, moe_gmm
from .admission_ctrl import admission_ctrl
from .admission_window import admission_window
from .backlog_scan import backlog_scan
from .decode_attn import decode_attention, decode_attention_partial
from .deposit import deposit, deposit_segments
from .moe_gmm import gmm

_COUNTED = {"gmm": moe_gmm, "decode_attention": decode_attn,
            "deposit": _deposit, "backlog_scan": _scan,
            "admission_window": _window, "admission_ctrl": _ctrl}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
    moe_gmm.path_launches = dict.fromkeys(moe_gmm.path_launches, 0)
    decode_attn.mode_launches = dict.fromkeys(decode_attn.mode_launches, 0)


# The kernels whose launches are also counted by path or by mode.
_SPLIT = {"gmm": "path_launches", "decode_attention": "mode_launches"}


def launch_snapshot() -> dict[tuple[str, str | None], int]:
    """Every launch counter: (kernel, None) for ``launch_counts``', and
    (kernel, path or mode) for ``gmm``'s paths and ``decode_attention``'s
    modes."""
    out = {(name, None): mod.launches for name, mod in _COUNTED.items()}
    for name, attr in _SPLIT.items():
        out.update({(name, k): n
                    for k, n in getattr(_COUNTED[name], attr).items()})
    return out


def add_launches(delta: dict[tuple[str, str | None], int]) -> None:
    """Add ``delta`` (a difference of two ``launch_snapshot``s) to the
    counters: the launches a replayed CUDA graph makes again."""
    for (name, sub), n in delta.items():
        mod = _COUNTED[name]
        if sub is None:
            mod.launches += n
        else:
            getattr(mod, _SPLIT[name])[sub] += n


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_call(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Best-of-``iters`` wall time of ``fn(*args)``, seconds.

    Warmup calls absorb the kernels' first-use build; each timed call ends
    in ``torch.cuda.synchronize()`` so the device's work is inside the
    measurement.
    """
    for _ in range(max(warmup, 0)):
        fn(*args)
        _synchronize()
    best = float("inf")
    for _ in range(max(iters, 1)):
        _synchronize()
        t0 = time.perf_counter()
        fn(*args)
        _synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def expert_ffn(params: dict, xs: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Batched SwiGLU over expert buckets through ``gmm``: (E,C,d)->(E,C,d).

    silu(gmm(x, Wg)) * gmm(x, Wu), then gmm(., Wd), as
    ``repro.kernels.ops.expert_ffn_pallas`` chains it.  ``gmm`` is
    differentiable, so training's backward runs its dx and dw products
    through the kernel too; silu, the gate product and the casts are
    PyTorch.
    """
    xs = xs.to(compute_dtype).contiguous()
    wg = params["w_gate"].to(compute_dtype)
    wu = params["w_up"].to(compute_dtype)
    wd = params["w_down"].to(compute_dtype)
    gate = F.silu(gmm(xs, wg))
    up = gmm(xs, wu)
    return gmm(gate * up, wd)


__all__ = ["gmm", "decode_attention", "decode_attention_partial", "deposit", "deposit_segments",
           "backlog_scan", "admission_window", "admission_ctrl", "expert_ffn", "timed_call",
           "launch_counts", "reset_launch_counts", "launch_snapshot",
           "add_launches"]
