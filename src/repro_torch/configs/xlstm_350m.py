"""xlstm-350m [ssm] — 24L d1024 4H d_ff=0 vocab 50304; sLSTM + mLSTM
blocks (7:1 mLSTM:sLSTM), recurrent O(1) decode state.  [arXiv:2405.04517]

d_ff=0 per the assignment: the xLSTM blocks carry their own up/down
projections (d_inner = 2*d_model); there is no separate FFN sub-block.
Runs long_500k natively.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "xlstm-350m"

_UNIT = tuple(
    LayerSpec("slstm" if i == 7 else "mlstm", "none") for i in range(8)
)

CONFIG = ModelConfig(
    name=ARCH_ID,
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=_UNIT,
    mamba_expand=2,          # d_inner = 2 * d_model for the lstm blocks
    tie_embeddings=False,
)
