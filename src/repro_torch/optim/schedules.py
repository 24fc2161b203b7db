"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM's schedule);
counterpart of ``repro.optim.schedules``.

Each returns a function step -> multiplier in [0, 1], a 0-d f32 tensor
computed in f32 as the reference's jnp; ``step`` may be an int or a
tensor (the optimizer's ``count``, on its device).
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 \
            * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def wsd_schedule(warmup_steps: int, total_steps: int,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup -> long stable plateau -> short (1-decay_frac tail) decay.

    MiniCPM (arXiv:2404.06395) Sec. 4: the stable phase runs at peak LR and
    the final ``decay_frac`` of steps decays; as the reference, a
    linear-in-log decay to ``final_frac``.
    """
    decay_start = int(total_steps * (1.0 - decay_frac))
    # jnp.log of the weakly typed maximum: the log of its f32 rounding.
    log_final = torch.log(torch.tensor(max(final_frac, 1e-6),
                                       dtype=torch.float32))

    def fn(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        in_decay = (step - decay_start) / max(total_steps - decay_start, 1)
        in_decay = torch.clamp(in_decay, 0.0, 1.0)
        decay = torch.exp(log_final.to(step.device) * in_decay)
        out = torch.where(step < warmup_steps, warm, torch.ones_like(warm))
        return torch.where(step >= decay_start, decay, out)
    return fn
