"""Model zoo of the port (attention + dense/MoE FFN families so far)."""
from .config import LayerSpec, ModelConfig
from .frontends import random_batch
from .model import (cast_for_compute, decode_step, forward, init_cache,
                    init_params, prefill)
from .moe import apply_placement

__all__ = ["LayerSpec", "ModelConfig", "random_batch", "cast_for_compute",
           "decode_step", "forward", "init_cache", "init_params",
           "prefill", "apply_placement"]
