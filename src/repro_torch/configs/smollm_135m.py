"""smollm-135m [dense] — 30L d576 9H (GQA kv=3) d_ff=1536 vocab 49152;
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "smollm-135m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=10000.0,
    tie_embeddings=True,
)
