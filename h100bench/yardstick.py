"""The benchmark's yardstick: the card's data-sheet rates, the work a cell
needs (model flops, the ``gmm`` and ``decode_attention`` roofline counts)
and the reductions of a profiler trace (busy time, kernel time by name,
idle gaps).  Everything here is computed from the configuration file's
sizes and the traffic, never from the program's own counters, so a change
to the program cannot move it.  What depends on the architecture (the
multiply-adds a token needs, the flops of one attention pair, the head,
the routed experts' and decode attention's needs) is the cell's family's
(``families/``: ``fam`` below); how those combine into a unit's work is
here.

The counts follow the usual conventions, with each choice stated once:

* model flops count every matrix product a token needs, 2 flops a
  multiply-add: the attention projections, the dense and shared FFNs, the
  router, the ``top_k`` routed experts a token is sent to, and the output
  head over the published vocabulary where a logit is needed (prefill
  needs it at the last prompt position only).  Causal attention adds
  the family's flops per visible (query, key) pair (2 * 2 * hd * Hq a
  layer in ``attn_moe``).  Training is three
  times the forward (forward, dx, dw).  Nothing is counted for
  recomputation, capacity padding, masked chunk pairs or dropped copies.
* a kernel's least time is max(flops / 989e12, bytes / 3.35e12), each
  input byte counted read once and each output byte written once.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def attention_pairs(lengths) -> float:
    """Visible (query, key) pairs of causal prompts of these lengths."""
    return float(sum(n * (n + 1) // 2 for n in lengths))


def attention_flops(fam, s, pairs: float) -> float:
    return fam.pair_flops(s) * pairs


def prefill_flops(fam, s, batch: int, prompt: int) -> float:
    """One prefill of ``batch`` prompts of ``prompt`` tokens, logits at the
    last position of each."""
    tokens = batch * prompt
    return (2.0 * fam.token_matmul_params(s) * tokens
            + attention_flops(fam, s, attention_pairs([prompt] * batch))
            + fam.head_flops(s, batch))


def decode_flops(fam, s, batch: int, pos: int) -> float:
    """One decode step of ``batch`` rows at position ``pos`` (each row
    attends over ``pos + 1`` keys)."""
    return (2.0 * fam.token_matmul_params(s) * batch
            + attention_flops(fam, s, float(batch * (pos + 1)))
            + fam.head_flops(s, batch))


def train_flops(fam, s, batch: int, seq: int) -> float:
    """One training step on ``batch`` sequences of ``seq`` tokens: three
    times the forward, logits at every position."""
    tokens = batch * seq
    fwd = (2.0 * fam.token_matmul_params(s) * tokens
           + attention_flops(fam, s, attention_pairs([seq] * batch))
           + fam.head_flops(s, tokens))
    return 3.0 * fwd


def least_time_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def decode_attn_bytes(fam, s, positions) -> float:
    """Bytes one decode step's attention needs: the family's
    ``decode_attn_row_bytes`` of each row at its position."""
    return float(sum(fam.decode_attn_row_bytes(s, p) for p in positions))


# --------------------------------------------------------------------- #
# Profiler trace reductions
# --------------------------------------------------------------------- #

MARKER_KERNEL = "spin_kernel"      # torch.cuda._sleep, the segment marker


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += b - a
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """(start, length) of every stretch of [lo, hi] that no interval
    covers."""
    gaps, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, a - at))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi - at))
    return gaps


def segments(events, n_markers: int):
    """Split a device trace at its last ``n_markers`` marker launches.

    ``events`` are (name, start_s, end_s) in device order.  Returns the
    window (first marker's end, last marker's start), each segment's
    start (its opening marker's end) and, for each of the
    ``n_markers - 1`` segments between consecutive markers, its kernels
    (the markers and everything before the first are left out)."""
    marks = [i for i, e in enumerate(events) if MARKER_KERNEL in e[0]]
    if len(marks) < n_markers:
        raise ValueError(f"trace holds {len(marks)} markers, "
                         f"{n_markers} were launched")
    marks = marks[-n_markers:]
    segs = [[e for e in events[a + 1:b] if MARKER_KERNEL not in e[0]]
            for a, b in zip(marks, marks[1:])]
    starts = [events[i][2] for i in marks[:-1]]
    return (events[marks[0]][2], events[marks[-1]][1]), starts, segs


def time_by_name(events) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, a, b in events:
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def kernel_seconds(events, fragment: str) -> float:
    return sum(b - a for name, a, b in events if fragment in name)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered) / 100))
    return ordered[min(rank, len(ordered)) - 1]
