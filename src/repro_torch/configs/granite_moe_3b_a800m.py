"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-3b-a800m]

40 experts do not divide a 16-slot EP axis; with ``moe_slotting`` the
stack pads to 48 virtual slots (3 a device, the 8 dummies get no tokens).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "granite-moe-3b-a800m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                 # per-expert (fine-grained MoE)
    vocab_size=49155,
    pattern=(LayerSpec("attn", "moe"),),
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    rope_theta=10000.0,
    tie_embeddings=True,
)
