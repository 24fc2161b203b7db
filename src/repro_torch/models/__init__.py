"""Model zoo of the port: attention, Mamba, mLSTM and sLSTM mixers with
dense, MoE or no FFN, EP slotting, expert parallelism (``Parallel``) and
the stub vision/audio frontends."""
from .config import LayerSpec, ModelConfig
from .frontends import batch_specs, frontend_split, random_batch
from .model import (Parallel, cast_for_compute, decode_step, forward,
                    init_cache, init_params, loss_fn, n_scan_units, prefill)
from .moe import apply_placement

__all__ = ["LayerSpec", "ModelConfig", "Parallel", "batch_specs", "frontend_split",
           "random_batch", "cast_for_compute", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "n_scan_units", "prefill",
           "apply_placement"]
