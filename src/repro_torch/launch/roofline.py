"""Roofline terms of a dry-run cell (counterpart of
``repro.launch.roofline``), on the H100's rates.

Three terms per (arch x shape x mesh), in seconds, for rank 0's step:

    compute    = flops / PEAK_FLOPS          (bf16 dense tensor-core peak)
    memory     = bytes / HBM_BW              (HBM3 rate)
    collective = collective_bytes / LINK_BW  (NVLink 4, one direction)

The reference reads flops and bytes from the compiled HLO; the port
counts them over the eager program's ops (``op_analysis``).  It has no
HLO text to parse either: ``collective_stats`` prices the collective
calls the port's ``distributed.collectives`` recorded, with the
reference's ring costs (R = result bytes, g = group size): all-gather
R(g-1)/g, reduce-scatter R(g-1), all-reduce 2R(g-1)/g, all-to-all
R(g-1)/g, permute R.

``model_flops`` is the reference's yardstick as it is: 6 N_active tokens
(train) or 2 N_active tokens (inference) plus the exact attention term;
``useful_flops_ratio`` = model_flops / (flops x chips) shows the work a
step does beyond it (remat, capacity padding, masked attention chunks,
and work every rank repeats).

The bounds that ``chip_smoke.py`` holds its timed steps to are stated
here once: ``serve_weight_bytes`` (a decode step's bytes) and
``train_step_bound`` (a train step's flops and AdamW bytes).
"""
from __future__ import annotations

import dataclasses

from ..configs.shapes import ShapeSpec
from ..models.config import ModelConfig

# NVIDIA H100 SXM5 data sheet: the card's rates, not measurements.
CARD = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12,
                       "float64": 34e12}
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s: NVLink 4 (900 GB/s both ways), one way
HBM_BYTES = 80 * 2**30       # device memory of the card

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_cost(op: str, result_bytes: float, group: int) -> float:
    """Bytes one chip sends for one call (the reference's ring costs)."""
    g = max(group, 1)
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {op!r}; known: {COLLECTIVES}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_per_chip: float
    total_result_bytes: float

    def asdict(self):
        return {"counts": self.counts, "bytes_per_chip": self.bytes_per_chip,
                "total_result_bytes": self.total_result_bytes}


def collective_stats(records, n_devices: int) -> CollectiveStats:
    """Ring costs over collective records: dicts with ``op`` (one of
    ``COLLECTIVES``), ``result_bytes``, ``group_size`` (None: all
    ``n_devices``) and an optional ``count`` (calls the record stands for,
    default 1)."""
    counts: dict[str, int] = {}
    per_chip = 0.0
    total = 0.0
    for rec in records:
        op, r, n = rec["op"], rec["result_bytes"], rec.get("count", 1)
        g = rec["group_size"] or n_devices
        counts[op] = counts.get(op, 0) + n
        per_chip += n * ring_cost(op, r, g)
        total += n * r
    return CollectiveStats(counts=counts, bytes_per_chip=per_chip,
                           total_result_bytes=total)


# --------------------------------------------------------------------- #
# MODEL_FLOPS (the "useful work" yardstick)
# --------------------------------------------------------------------- #


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference) + exact attention."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    n_attn_layers = sum(
        1 for i in range(cfg.n_layers)
        if cfg.pattern[i % len(cfg.pattern)].mixer == "attn"
    )
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * tokens
        # causal attention: fwd 2*2*S^2/2*d_attn per layer, x3 with backward
        attn = (3 * 2 * 2 * 0.5 * shape.seq_len ** 2 * cfg.q_dim
                * n_attn_layers * shape.global_batch)
        return base + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n_active * tokens
        attn = (2 * 2 * 0.5 * shape.seq_len ** 2 * cfg.q_dim
                * n_attn_layers * shape.global_batch)
        return base + attn
    # decode: one token per sequence, attention reads the whole cache
    tokens = shape.global_batch
    base = 2.0 * n_active * tokens
    attn = (2 * 2 * shape.seq_len * cfg.q_dim * n_attn_layers * tokens)
    return base + attn


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    n_devices: int
    model_flops_total: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs * chips): remat and redundancy."""
        total = self.flops_per_chip * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bottleneck time: 1.0 means the step is
        fully explained by MODEL_FLOPS at the card's peak."""
        ideal = self.model_flops_total / (self.n_devices * PEAK_FLOPS)
        return ideal / self.bound_time_s if self.bound_time_s else 0.0

    def asdict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "n_devices": self.n_devices,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def derive(cost: dict, coll: CollectiveStats, n_devices: int,
           model_flops_total: float) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll.bytes_per_chip / LINK_BW,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        coll_bytes_per_chip=coll.bytes_per_chip,
        n_devices=n_devices,
        model_flops_total=model_flops_total,
    )


def derive_from_op_cost(op_cost, n_devices: int,
                        model_flops_total: float) -> Roofline:
    """Roofline terms from ``op_analysis.OpCost`` (rank 0's counted step)."""
    return Roofline(
        compute_s=op_cost.flops / PEAK_FLOPS,
        memory_s=op_cost.bytes_accessed / HBM_BW,
        collective_s=op_cost.collective_bytes / LINK_BW,
        flops_per_chip=float(op_cost.flops),
        bytes_per_chip=float(op_cost.bytes_accessed),
        coll_bytes_per_chip=op_cost.collective_bytes,
        n_devices=n_devices,
        model_flops_total=model_flops_total,
    )


# --------------------------------------------------------------------- #
# Step bounds from the config (chip_smoke.py's timed steps)
# --------------------------------------------------------------------- #


def block_specs(cfg: ModelConfig) -> list:
    """Every block's spec in order, the dense first block included."""
    from ..models.model import _first_spec, layer_specs
    return ([_first_spec(cfg)] if cfg.first_layer_dense else []) \
        + layer_specs(cfg)


def n_ffn_layers(cfg: ModelConfig) -> tuple[int, int]:
    """(MoE layers, dense-FFN layers after the dense first block)."""
    from ..models.model import layer_specs
    specs = layer_specs(cfg)
    n_moe = sum(spec.ffn == "moe" for spec in specs)
    return n_moe, sum(spec.ffn == "dense" for spec in specs)


def mixer_bytes(cfg: ModelConfig, mixer: str, batch: int) -> tuple[int, int]:
    """(weight bytes, state bytes) one decode step of one ``mixer`` block
    moves: its bf16 weights and f32 parameters read once, its f32
    recurrent state read and written once (the KV cache is counted by
    ``decode_attention``'s own bound)."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // nh
    n, r, dc = cfg.mamba_d_state, cfg.mamba_dt_rank, cfg.mamba_d_conv
    if mixer == "attn":
        return (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim) * 2, 0
    if mixer == "mamba":
        bf16 = 2 * d * di + dc * di + 2 * di + di * (r + 2 * n) + r * di + di * d
        return bf16 * 2 + (di + di * n) * 4, \
            2 * batch * ((dc - 1) * di + di * n) * 4
    if mixer == "mlstm":
        return 5 * d * di * 2 + (2 * d * nh + 2 * nh) * 4, \
            2 * batch * nh * (dh * dh + dh + 1) * 4
    return (4 * d * di + di * d) * 2 + (nh * dh * 4 * dh + 4 * di) * 4, \
        2 * batch * 4 * nh * dh * 4


def serve_weight_bytes(cfg: ModelConfig, batch: int) -> dict[str, float]:
    """Bytes a decode step of ``batch`` rows must move once: every bf16
    weight (every routed expert: the buckets cover every expert; the
    shared experts, the dense first block, the dense FFNs, each kind of
    mixer, the LM head or the tied embedding table, of which the step
    gathers B rows), the recurrent mixers' f32 parameters, and their f32
    state read and written (``state``: mLSTM's (B, NH, dh, dh) memory
    above all)."""
    n_moe, n_dense = n_ffn_layers(cfg)
    d, f = cfg.d_model, cfg.d_ff_expert
    parts = {
        "experts": n_moe * cfg.n_experts * 3 * d * f * 2,
        "shared": n_moe * 3 * d * f * cfg.n_shared_experts * 2,
        "first": (3 * d * (cfg.first_dense_d_ff or cfg.d_ff) * 2
                  if cfg.first_layer_dense else 0),
        "ffn": n_dense * 3 * d * cfg.d_ff * 2,
        "attention": 0, "mamba": 0, "mlstm": 0, "slstm": 0, "state": 0,
        "head": d * cfg.padded_vocab * 2,
    }
    for spec in block_specs(cfg):
        weights, state = mixer_bytes(cfg, spec.mixer, batch)
        parts["attention" if spec.mixer == "attn" else spec.mixer] += weights
        parts["state"] += state
    return parts


def train_step_bound(cfg: ModelConfig, n_params: int, batch: int,
                     seq: int) -> dict:
    """The least time a full-width train step of ``batch`` x ``seq``
    tokens could take, from the config: bf16 tensor work (forward;
    backward twice the forward; unit remat's second forward of every
    layer) at PEAK_FLOPS, plus AdamW's bytes (p, g, m and v read, p, m and
    v written, g read again for the norm; f32) at HBM_BW.  Only the work
    a step needs is counted: the causal attention's S(S+1)/2 query-key
    pairs a head (the port computes every chunk pair, masked or not),
    and the expert products over the T * K routed rows (the port runs
    the capacity-padded E * C)."""
    t = batch * seq
    d, f = cfg.d_model, cfg.d_ff_expert
    layers = cfg.n_layers
    gmm = 3 * 2 * t * cfg.top_k * d * f
    proj = 2 * t * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * t * cfg.q_dim * d
    pairs = batch * cfg.n_heads * seq * (seq + 1) // 2
    attn = 2 * 2 * pairs * cfg.head_dim
    router = 2 * t * d * cfg.n_experts
    head = 2 * t * d * cfg.padded_vocab
    layer = gmm + proj + attn + router
    fwd = layers * layer + head
    flops = 3 * fwd + layers * layer
    adam_bytes = 8 * 4 * n_params
    ops_ms = flops / PEAK_FLOPS * 1e3
    bytes_ms = adam_bytes / HBM_BW * 1e3
    return {"gmm_gflop_layer": gmm / 1e9, "proj_gflop_layer": proj / 1e9,
            "attn_gflop_layer": attn / 1e9, "head_gflop": head / 1e9,
            "forward_tflop": fwd / 1e12, "step_tflop": flops / 1e12,
            "adamw_gb": adam_bytes / 1e9, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": ops_ms + bytes_ms}


__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_BY_DTYPE", "HBM_BW", "LINK_BW",
           "HBM_BYTES", "CARD", "COLLECTIVES", "ring_cost", "CollectiveStats",
           "collective_stats", "model_flops", "Roofline", "derive",
           "derive_from_op_cost", "block_specs", "n_ffn_layers",
           "mixer_bytes", "serve_weight_bytes", "train_step_bound"]
