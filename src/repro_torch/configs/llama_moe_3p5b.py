"""llama-moe-3.5b — the paper's own model (Sec. VII-A2): LLaMA-MoE-3.5B
(2/8), 32 MoE layers x 8 experts, top-2; experts are the LLaMA-2-7B FFN
(d_ff 11008) split 8 ways (d_ff 1376 each).  [arXiv:2406.16554]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "llama-moe-3.5b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=1376,
    vocab_size=32000,
    pattern=(LayerSpec("attn", "moe"),),
    n_experts=8,
    top_k=2,
    d_ff_expert=1376,
    rope_theta=10000.0,
)
