"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576,
vocab 65536, MoE 16e top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887]

Pattern unit of 8 layers (9 scan units): attention at position 4, Mamba
elsewhere; MoE replaces the FFN on every other layer (4 MoE / 4 dense per
unit), matching Jamba's e=2 MoE stride.  Runs long_500k: the Mamba state is
O(1) per token and only 9 attention layers keep KV.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "jamba-1.5-large-398b"

_UNIT = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 0 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_UNIT,
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_d_conv=4,
    rope_theta=10000.0,
)
