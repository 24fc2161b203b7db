"""minicpm-2b [dense] — 40L d2304 36H (MHA kv=36) d_ff=5760 vocab 122753;
llama-like arch (trained with the WSD schedule, which only training uses).
[arXiv:2404.06395]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "minicpm-2b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10000.0,
    tie_embeddings=True,
)
