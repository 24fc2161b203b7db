"""Oracles for the kernels, under the reference's names.

``repro.kernels.ref`` holds the jnp oracles the Pallas kernels are held
to; in the port those oracles are the plain versions that sit beside each
kernel, so this module names them for a reader coming from the reference.
"""
from __future__ import annotations

from .decode_attn import decode_attention_plain as decode_attention_ref
from .moe_gmm import gmm_plain as gmm_ref

__all__ = ["gmm_ref", "decode_attention_ref"]
