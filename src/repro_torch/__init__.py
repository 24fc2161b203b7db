"""SpaceMoE port to PyTorch and CUDA (counterpart of the ``repro`` package).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), where every kernel runs as its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain "
            "versions on the CPU")
    return dev
