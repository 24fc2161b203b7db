"""mistral-large-123b [dense] — 88L d12288 96H (GQA kv=8) d_ff=28672
vocab 32768.  [hf:mistralai/Mistral-Large-Instruct-2407]

Its 123 B parameters do not fit one card in bf16, and the port has no
sharding yet, so it runs at smoke size only.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "mistral-large-123b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=1_000_000.0,
)
