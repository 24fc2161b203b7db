"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d4096 32H
(GQA kv=8) d_ff=14336 vocab 32000; anyres vision tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The CLIP tower + anyres projector are a STUB: ``models.frontends``
supplies up to 576 precomputed patch embeddings (one base tile)
prepended to the text tokens.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "llava-next-mistral-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=1_000_000.0,
    frontend="vision",
)
