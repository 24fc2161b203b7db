"""musicgen-medium [audio] — 48L d1536 24H (MHA kv=24) d_ff=6144
vocab 2048; decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec tokenizer + codebook-interleaving frontend is a STUB:
``models.frontends`` supplies precomputed frame embeddings; the codec
token ids remain the prediction targets.  (FFN family normalized to
SwiGLU across the zoo, as in the reference.)
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "musicgen-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10000.0,
    frontend="audio",
)
