"""deepseek-moe-16b [moe] — 28L d2048 16H (MHA kv=16) d_ff=1408/expert,
vocab 102400, 2 shared + 64 routed top-6, fine-grained; first layer dense
(d_ff 10944).  [arXiv:2401.06066]

The hero arch for the paper's technique: fine-grained experts have the most
skewed activation statistics, and 64 experts divide the 16-way model axis
exactly (4 experts/device — the Sec. VI-B multi-expert regime).  Shared
experts are the P_i -> 1 limit of Theorem 1: always active, so they are
pinned (replicated) rather than placed.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "deepseek-moe-16b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                # per routed expert
    vocab_size=102400,
    pattern=(LayerSpec("attn", "moe"),),
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    first_layer_dense=True,
    first_dense_d_ff=10944,
    rope_theta=10000.0,
)
