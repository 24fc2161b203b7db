"""The benchmark's yardstick: the card's data-sheet rates, the work a cell
needs (model flops, the ``gmm`` and ``decode_attention`` roofline counts)
and the reductions of a profiler trace (busy time, kernel time by name,
idle gaps).  Everything here is computed from the configuration file's
sizes and the traffic, never from the program's own counters, so a change
to the program cannot move it.

The counts follow the usual conventions, with each choice stated once:

* model flops count every matrix product a token needs, 2 flops a
  multiply-add: the attention projections, the dense and shared FFNs, the
  router, the ``top_k`` routed experts a token is sent to, and the output
  head over the published vocabulary where a logit is needed (prefill
  needs it at the last prompt position only).  Causal attention adds
  2 * 2 * hd * Hq flops per visible (query, key) pair.  Training is three
  times the forward (forward, dx, dw).  Nothing is counted for
  recomputation, capacity padding, masked chunk pairs or dropped copies.
* a kernel's least time is max(flops / 989e12, bytes / 3.35e12), each
  input byte counted read once and each output byte written once.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM5 data sheet, dense rates, at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The model's sizes as the configuration file states them."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    padded_vocab: int
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int
    first_dense_d_ff: int          # 0: no dense first layer
    tie_embeddings: bool
    rope_theta: float
    norm_eps: float
    capacity_factor: float

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - (1 if self.first_dense_d_ff else 0)

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert for a routing group of ``n_tokens`` tokens."""
        c = math.ceil(self.capacity_factor * n_tokens * self.top_k
                      / self.n_experts)
        return max(c, self.top_k)


def sizes_of(model: dict) -> Sizes:
    """``Sizes`` from a configuration file's ``model`` group."""
    return Sizes(**{f.name: model[f.name] for f in dataclasses.fields(Sizes)})


def token_matmul_params(s: Sizes) -> float:
    """Multiply-adds a token needs outside attention's score products and
    the output head."""
    attn = s.d_model * (s.q_dim + 2 * s.kv_dim) + s.q_dim * s.d_model
    expert = 3 * s.d_model * s.d_expert
    moe = s.d_model * s.n_experts + (s.top_k + s.n_shared) * expert
    dense = 3 * s.d_model * s.first_dense_d_ff
    return s.n_layers * attn + s.n_moe_layers * moe + dense


def attention_pairs(lengths) -> float:
    """Visible (query, key) pairs of causal prompts of these lengths."""
    return float(sum(n * (n + 1) // 2 for n in lengths))


def attention_flops(s: Sizes, pairs: float) -> float:
    return 4.0 * s.q_dim * s.n_layers * pairs


def head_flops(s: Sizes, n_logits: float) -> float:
    return 2.0 * s.d_model * s.vocab_size * n_logits


def prefill_flops(s: Sizes, batch: int, prompt: int) -> float:
    """One prefill of ``batch`` prompts of ``prompt`` tokens, logits at the
    last position of each."""
    tokens = batch * prompt
    return (2.0 * token_matmul_params(s) * tokens
            + attention_flops(s, attention_pairs([prompt] * batch))
            + head_flops(s, batch))


def decode_flops(s: Sizes, batch: int, pos: int) -> float:
    """One decode step of ``batch`` rows at position ``pos`` (each row
    attends over ``pos + 1`` keys)."""
    return (2.0 * token_matmul_params(s) * batch
            + attention_flops(s, float(batch * (pos + 1)))
            + head_flops(s, batch))


def train_flops(s: Sizes, batch: int, seq: int) -> float:
    """One training step on ``batch`` sequences of ``seq`` tokens: three
    times the forward, logits at every position."""
    tokens = batch * seq
    fwd = (2.0 * token_matmul_params(s) * tokens
           + attention_flops(s, attention_pairs([seq] * batch))
           + head_flops(s, tokens))
    return 3.0 * fwd


def least_time_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def gmm_need(s: Sizes, n_tokens: int, backward: bool = False) -> tuple[float, float]:
    """(flops, bytes) the routed experts of every MoE layer need for
    ``n_tokens`` tokens: T * top_k copies through gate, up and down; with
    ``backward`` also each product's dx and dw.  Bytes: each product's
    input rows, its expert weights and its output rows, in bf16."""
    copies = n_tokens * s.top_k
    d, f, e = s.d_model, s.d_expert, s.n_experts
    flops = 3 * 2.0 * copies * d * f
    weights = 3 * e * d * f
    rows = copies * (2 * (d + f) + (f + d))   # gate, up: d in, f out; down
    nbytes = BF16_BYTES * (weights + rows)
    if backward:
        # dx reads dy and w, writes dx; dw reads x and dy, writes dw.
        flops *= 3
        nbytes += 2 * BF16_BYTES * (weights + rows)
    return flops * s.n_moe_layers, nbytes * s.n_moe_layers


def decode_attn_bytes(s: Sizes, positions) -> float:
    """Bytes one decode step's attention needs in every layer: for each
    row at ``pos``, its K and V rows [0, pos] read once, q read and the
    output written once (bf16)."""
    per_row_kv = 2 * s.kv_dim * BF16_BYTES
    per_row_q = 2 * s.q_dim * BF16_BYTES
    total = sum((p + 1) * per_row_kv + per_row_q for p in positions)
    return float(total) * s.n_layers


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
