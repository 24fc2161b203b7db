"""The port's chunked prefill attention against the reference's, on the
CPU.

``flash_attention`` and ``_flash_fwd``'s log-sum-exp on the same numpy
inputs: chunks that do not divide S evenly from their targets (both
packages pick the largest divisor below the target), a sliding window,
a logit softcap, G query heads per KV head, queries past position 0,
and bf16 inputs.  f32 at atol = rtol = 1e-5 (summation order only, the
tolerance of ``tests/test_torch_model.py``'s attention test); bf16 at
2e-2 (one bf16 rounding of the output, 2^-8 relative, with room for a
product summed in another order).  Also ``_pick_chunk``,
``_mask_block`` and ``attention_prefill`` (output and the K/V it
writes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro_torch.models.attention as tattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.models.config import ModelConfig as TConfig

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# (S, q chunk target, kv chunk target, Hq, Hkv, sliding window, softcap)
CASES = {
    "uneven-chunks": (24, 16, 10, 4, 4, 0, 0.0),      # picks 12 and 8
    "gqa-g4": (32, 8, 8, 8, 2, 0, 0.0),
    "mqa-g8-uneven": (30, 16, 7, 8, 1, 0, 0.0),       # picks 15 and 6
    "window": (30, 16, 16, 4, 2, 7, 0.0),             # whole chunks masked
    "softcap": (32, 8, 16, 4, 2, 0, 2.0),
    "window-softcap-g3": (36, 8, 10, 6, 2, 5, 3.0),   # picks 6 and 9
    "one-chunk": (17, 512, 1024, 4, 2, 0, 0.0),       # prime S: one block
}


def _cfgs(s, qc, kc, hq, hkv, window, cap, dtype="float32"):
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=hq, n_kv_heads=hkv,
              head_dim=8, d_ff=64, vocab_size=128, attn_q_chunk=qc,
              attn_kv_chunk=kc, sliding_window=window,
              attn_logit_softcap=cap, compute_dtype=dtype)
    return JConfig(**kw), TConfig(**kw)


def _inputs(s, hq, hkv, offset=0, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, s, hq, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, hkv, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, hkv, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32),
                          (2, s)).copy()
    return q, k, v, pos


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_fwd_matches_reference(case, offset):
    """``_flash_fwd``'s output and log-sum-exp, and ``flash_attention``."""
    s, qc, kc, hq, hkv, window, cap = CASES[case]
    jc, tc = _cfgs(*CASES[case])
    assert tattn._pick_chunk(s, qc) == jattn._pick_chunk(s, qc)
    q, k, v, pos = _inputs(s, hq, hkv, offset)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    targs = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    want, want_lse = jattn._flash_fwd(jc, *jargs)
    got, got_lse = tattn._flash_fwd(tc, *targs)
    assert tuple(got.shape) == (2, s, hq, 8)
    assert tuple(got_lse.shape) == (2, hkv, hq // hkv, s)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), **TOL["float32"])
    np.testing.assert_allclose(_np(tattn.flash_attention(tc, *targs)),
                               _np(jattn.flash_attention(jc, *jargs)),
                               **TOL["float32"])


@pytest.mark.parametrize("case", ["gqa-g4", "window-softcap-g3"])
def test_flash_attention_bf16_matches_reference(case):
    """bf16 q/k/v: f32 scores and accumulation, probabilities rounded to
    bf16 before the PV product, the output in bf16."""
    s, _, _, hq, hkv, _, _ = CASES[case]
    jc, tc = _cfgs(*CASES[case], dtype="bfloat16")
    q, k, v, pos = _inputs(s, hq, hkv)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jattn.flash_attention(jc, *jargs, jnp.asarray(pos), jnp.asarray(pos))
    got = tattn.flash_attention(tc, *targs, torch.from_numpy(pos),
                                torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("s", [1, 7, 12, 17, 36, 64, 100])
@pytest.mark.parametrize("target", [1, 5, 8, 16, 512])
def test_pick_chunk_matches_reference(s, target):
    got = tattn._pick_chunk(s, target)
    assert got == jattn._pick_chunk(s, target)
    assert s % got == 0 and got <= max(target, 1)


@pytest.mark.parametrize("window", [0, 3])
def test_mask_block_matches_reference(window):
    jc, tc = _cfgs(12, 4, 4, 4, 2, window, 0.0)
    rng = np.random.default_rng(4)
    qpos = rng.integers(0, 20, (2, 4)).astype(np.int32)
    kpos = rng.integers(0, 20, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tattn._mask_block(tc, torch.from_numpy(qpos),
                          torch.from_numpy(kpos)).numpy(),
        np.asarray(jattn._mask_block(jc, jnp.asarray(qpos),
                                     jnp.asarray(kpos))))


@pytest.mark.parametrize("case", ["uneven-chunks", "window-softcap-g3"])
def test_attention_prefill_matches_reference(case):
    """``attention_prefill`` through the chunked path: the output, and the
    K/V written at [0, S) of a longer cache."""
    s, _, _, hq, hkv, _, _ = CASES[case]
    jc, tc = _cfgs(*CASES[case])
    rng = np.random.default_rng(5)
    params = {"w_q": rng.normal(size=(32, jc.q_dim)) * 0.2,
              "w_k": rng.normal(size=(32, jc.kv_dim)) * 0.2,
              "w_v": rng.normal(size=(32, jc.kv_dim)) * 0.2,
              "w_o": rng.normal(size=(jc.q_dim, 32)) * 0.2}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    jcache = jattn.init_kv_cache(jc, 2, s + 4, jnp.float32)
    want, jcache = jattn.attention_prefill(
        jc, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(pos), jcache, jnp.float32)
    tcache = tattn.init_kv_cache(tc, 2, s + 4, torch.float32, "cpu")
    got, tcache = tattn.attention_prefill(
        tc, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), torch.from_numpy(pos), tcache, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL["float32"])
