"""Per-token FLOP + byte accounting for the distributed MoE workload.

The gateway satellite executes attention (+KV cache), layernorm, gating and
aggregation; each expert satellite executes one FFN.  FLOPs = 2*MACs
(Eq. 16 input).  The ``*_bytes`` methods account HBM traffic for the
roofline memory term (``repro_torch.core.calibration``): weight reads are split
from per-token reads (KV cache, activations) because weights amortize over
a decode batch while per-token traffic does not.

A copy of ``repro.core.workload`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEWorkload:
    """Decode-time FLOPs per token for one MoE layer."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    vocab_size: int = 32000
    gated_ffn: bool = True      # SwiGLU (3 mats) vs MLP (2 mats)
    dtype_bytes: int = 2        # weight/activation element size (bf16)

    # -- gateway satellite ------------------------------------------------
    def attention_flops(self, ctx_len: int) -> float:
        d, hd = self.d_model, self.head_dim
        q = 2 * d * self.n_heads * hd
        kv = 2 * 2 * d * self.n_kv_heads * hd
        o = 2 * self.n_heads * hd * d
        scores = 2 * self.n_heads * hd * ctx_len
        weighted = 2 * self.n_heads * hd * ctx_len
        return float(q + kv + o + scores + weighted)

    def gating_flops(self) -> float:
        return float(2 * self.d_model * self.n_experts)

    def aggregation_flops(self) -> float:
        return float(self.top_k * self.d_model)

    def gateway_flops(self, ctx_len: int) -> float:
        norms = 4 * self.d_model
        return self.attention_flops(ctx_len) + self.gating_flops() \
            + self.aggregation_flops() + norms

    # -- expert satellite --------------------------------------------------
    @property
    def expert_flops(self) -> float:
        mats = 3 if self.gated_ffn else 2
        return float(2 * mats * self.d_model * self.d_ff_expert)

    # -- head (runs on the last gateway, once per token) -------------------
    @property
    def lm_head_flops(self) -> float:
        return float(2 * self.d_model * self.vocab_size)

    # -- HBM byte accounting (roofline memory term) ------------------------
    @property
    def gateway_weight_bytes(self) -> float:
        """Batch-amortizable gateway reads: attention projections + router."""
        d, hd = self.d_model, self.head_dim
        proj = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        router = d * self.n_experts
        return float((proj + router) * self.dtype_bytes)

    def gateway_token_bytes(self, ctx_len: int) -> float:
        """Per-token gateway reads: the KV cache plus activation vectors."""
        kv = 2 * ctx_len * self.n_kv_heads * self.head_dim
        act = 6 * self.d_model            # residual/q/attn-out/gate/combine
        return float((kv + act) * self.dtype_bytes)

    def gateway_bytes(self, ctx_len: int) -> float:
        """Total gateway bytes per token at batch 1."""
        return self.gateway_weight_bytes + self.gateway_token_bytes(ctx_len)

    @property
    def expert_weight_bytes(self) -> float:
        """Batch-amortizable expert reads: one expert's FFN matrices."""
        mats = 3 if self.gated_ffn else 2
        return float(mats * self.d_model * self.d_ff_expert * self.dtype_bytes)

    @property
    def expert_token_bytes(self) -> float:
        """Per-visit expert reads/writes: in/out rows + hidden activations."""
        mats = 3 if self.gated_ffn else 2
        return float((2 * self.d_model + (mats - 1) * self.d_ff_expert)
                     * self.dtype_bytes)

    @property
    def expert_bytes(self) -> float:
        """Total expert bytes per visit at batch 1."""
        return self.expert_weight_bytes + self.expert_token_bytes

    @property
    def lm_head_weight_bytes(self) -> float:
        """Batch-amortizable head reads: the unembedding matrix."""
        return float(self.d_model * self.vocab_size * self.dtype_bytes)

    @property
    def lm_head_token_bytes(self) -> float:
        """Per-token head traffic: hidden vector in, logits out."""
        return float((self.d_model + self.vocab_size) * self.dtype_bytes)

    @property
    def lm_head_bytes(self) -> float:
        """Total head bytes per token at batch 1."""
        return self.lm_head_weight_bytes + self.lm_head_token_bytes

    @staticmethod
    def from_model_config(cfg) -> "MoEWorkload":
        """Workload view of a registry :class:`~repro_torch.models.config.ModelConfig`.

        Duck-typed (no ``repro_torch.models`` import from core): any object with
        the MoE config fields works.  Raises for dense configs.
        """
        if not getattr(cfg, "n_experts", 0) or not getattr(cfg, "top_k", 0):
            raise ValueError(f"{getattr(cfg, 'name', cfg)!r}: not a MoE config")
        return MoEWorkload(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            d_ff_expert=cfg.d_ff_expert, n_experts=cfg.n_experts,
            top_k=cfg.top_k, vocab_size=cfg.vocab_size,
        )

    @staticmethod
    def llama_moe_3p5b() -> "MoEWorkload":
        """LLaMA-MoE-3.5B (2/8) — paper Sec. VII-A2.

        LLaMA-2-7B FFN (d_ff=11008) split into 8 experts of d_ff=1376;
        32 layers, top-2, d_model=4096.  Active params ~3.5B of 6.7B total.
        """
        return MoEWorkload(
            d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
            d_ff_expert=1376, n_experts=8, top_k=2, vocab_size=32000,
        )
