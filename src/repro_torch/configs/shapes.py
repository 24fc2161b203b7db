"""Assigned input shapes (the x-axis of the 40-cell dry-run matrix)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applies(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic (SSM/hybrid) archs
    — pure full-attention archs skip it (see DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(full-attention): 512k dense KV cache is not this arch"
    return True, ""
