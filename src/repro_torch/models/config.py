"""Model configuration for the composable LM zoo (own copy of
``repro.models.config``, field for field).

A model is a stack of ``n_layers`` blocks described by a repeating
``pattern`` of (mixer, ffn) pairs.  ``len(pattern)`` must divide
``n_layers``; the reference scans over ``n_units`` units, the port loops
over them in Python.  Fields for features the port does not run yet
(SSM mixers, remat) are kept so that one config describes the same
model in both packages.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One block of the repeating pattern."""

    mixer: str = "attn"     # "attn" | "mamba" | "mlstm" | "slstm"
    ffn: str = "dense"      # "dense" | "moe" | "none"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0                    # 0 => d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_layer_dense: bool = False      # deepseek-moe: layer 0 is dense FFN
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # --- attention ---
    qkv_bias: bool = False               # qwen2.5
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0              # 0 => full causal

    # --- SSM / recurrent ---
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0               # 0 => ceil(d_model / 16)

    # --- embeddings / head ---
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # --- modality frontend (stub; see models/frontends.py) ---
    frontend: str = ""                  # "" | "vision" | "audio"

    # --- execution knobs (perf pass) ---
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    remat: str = "unit"                  # "none" | "unit"
    moe_impl: str = "einsum"             # "einsum" (GShard-style) | "ragged"
    moe_slotting: bool = False           # EP slot layout (pad/fragment) so
    moe_ep_slots: int = 16               #   any E runs expert-parallel
    flash_vjp: bool = False              # custom-VJP flash attention (bwd
    #   recomputes P chunk-wise instead of saving it; see attention.py)
    use_pallas_decode: bool = False      # decode attention via the Pallas
    #   flash-decode kernel (kernels/decode_attn); interpret-mode on CPU

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: len(pattern)={len(self.pattern)} must divide "
                f"n_layers={self.n_layers}"
            )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank", -(-self.d_model // 16))
        if any(s.ffn == "moe" for s in self.pattern):
            if self.n_experts <= 0 or self.top_k <= 0:
                raise ValueError(f"{self.name}: MoE pattern needs n_experts/top_k")
            if self.d_ff_expert == 0:
                object.__setattr__(self, "d_ff_expert", self.d_ff)

    # ------------------------------------------------------------------ #
    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def has_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.pattern)

    @property
    def is_recurrent(self) -> bool:
        """True if every mixer carries O(1) decode state (no KV growth)."""
        return all(s.mixer in ("mamba", "mlstm", "slstm") for s in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic prefill / O(1)-ish decode state per the assignment:
        SSM / hybrid archs run long_500k; pure full-attention archs skip."""
        return any(s.mixer in ("mamba", "mlstm", "slstm") for s in self.pattern)

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----------- #
    def param_counts(self) -> dict[str, float]:
        """Approximate parameter counts: total and active-per-token."""
        d = self.d_model
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        total = float(emb)
        active = float(emb)
        for i in range(self.n_layers):
            spec = self.pattern[i % len(self.pattern)]
            if i == 0 and self.first_layer_dense:
                spec = LayerSpec(mixer=spec.mixer, ffn="dense")
                dff = self.first_dense_d_ff or self.d_ff
            else:
                dff = self.d_ff
            if spec.mixer == "attn":
                p = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            elif spec.mixer == "mamba":
                di = self.d_inner
                p = d * 2 * di + di * self.mamba_d_conv \
                    + di * (self.mamba_dt_rank + 2 * self.mamba_d_state) \
                    + self.mamba_dt_rank * di + di * self.mamba_d_state + di * d
            else:  # mlstm / slstm
                di = self.d_inner
                p = d * 3 * di + 3 * di + di * d   # qkv-ish + gates + out
            total += p
            active += p
            if spec.ffn == "dense":
                total += 3 * d * dff
                active += 3 * d * dff
            elif spec.ffn == "moe":
                e = 3 * d * self.d_ff_expert
                total += self.n_experts * e + self.n_shared_experts * e \
                    + d * self.n_experts
                active += self.top_k * e + self.n_shared_experts * e \
                    + d * self.n_experts
        return {"total": total, "active": active}
