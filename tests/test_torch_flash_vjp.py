"""The port's custom-VJP flash attention (``attention._flash_vjp_fn``)
against the reference's, on the CPU.

dq, dk and dv of a squared-error loss on the same numpy inputs for the
six cases of ``tests/test_perf_features.py``'s flash-VJP test (sliding
window 0 and 8; Hq/Hkv 4/2, 4/4, 8/1; S = 32, q chunks of 8, KV chunks
of 16), in f32 at atol = rtol = 1e-5 (summation order only: the
reference's scans and the port's loops add the same chunk products, in
the same order); the same grads against the port's autograd through
``_flash_fwd`` (another algorithm for the same derivative: atol 1e-4,
the reference test's tolerance against its naive attention); in bf16,
the two packages within 2e-2 of each grad's largest value (the chunk
intermediates rounded to bf16 in both, products summed in another
order).  Whole-model grads with ``flash_vjp`` on and off agree
(atol 2e-4, rtol 2e-3, the reference's own test), and a logit softcap
raises ``NotImplementedError`` in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro_torch.models as tmodels
import repro_torch.models.attention as tattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.tree import tree_leaves, tree_map

B, S, HD = 2, 32, 8
CASES = [(sw, hq, hkv) for sw in (0, 8) for hq, hkv in ((4, 2), (4, 4), (8, 1))]


def _cfgs(hq, hkv, sw, dtype="float32", **kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=hq, n_kv_heads=hkv,
                d_ff=64, vocab_size=128, attn_q_chunk=8, attn_kv_chunk=16,
                compute_dtype=dtype, flash_vjp=True, sliding_window=sw, **kw)
    return JConfig(**base), TConfig(**base)


def _inputs(hq, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, hq, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, hkv, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, hkv, HD)).astype(np.float32)
    tgt = rng.normal(size=(B, S, hq, HD)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, tgt, pos


def _ref_grads(jc, q, k, v, tgt, pos, dtype=jnp.float32):
    pos = jnp.asarray(pos)

    def loss(*a):
        out = jattn.flash_attention(jc, *a, pos, pos).astype(jnp.float32)
        return jnp.sum((out - tgt) ** 2)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, (0, 1, 2))(*args)]


def _port_grads(tc, q, k, v, tgt, pos, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_(True)
            for x in (q, k, v)]
    pos = torch.from_numpy(pos)
    out = tattn.flash_attention(tc, *args, pos, pos).float()
    loss = torch.sum((out - torch.from_numpy(tgt)) ** 2)
    return [g.float().numpy() for g in torch.autograd.grad(loss, args)]


@pytest.mark.parametrize("sw,hq,hkv", CASES)
def test_flash_vjp_grads_match_reference(sw, hq, hkv):
    jc, tc = _cfgs(hq, hkv, sw)
    inputs = _inputs(hq, hkv)
    for got, want in zip(_port_grads(tc, *inputs), _ref_grads(jc, *inputs)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sw,hq,hkv", CASES)
def test_flash_vjp_grads_match_autograd(sw, hq, hkv):
    _, tc = _cfgs(hq, hkv, sw)
    inputs = _inputs(hq, hkv, seed=1)
    auto = _port_grads(dataclasses.replace(tc, flash_vjp=False), *inputs)
    for got, want in zip(_port_grads(tc, *inputs), auto):
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_flash_vjp_bf16_matches_reference():
    jc, tc = _cfgs(8, 2, 0, dtype="bfloat16")
    inputs = _inputs(8, 2, seed=2)
    got = _port_grads(tc, *inputs, dtype=torch.bfloat16)
    want = _ref_grads(jc, *inputs, dtype=jnp.bfloat16)
    for a, b in zip(got, want):
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-2)


def test_flash_vjp_whole_model_grads():
    """Training grads with flash_vjp equal grads without (the reference's
    ``test_flash_vjp_whole_model_grads`` on the port)."""
    _, cfg0 = _cfgs(4, 2, 0)
    cfg0 = dataclasses.replace(cfg0, flash_vjp=False, attn_kv_chunk=8)
    cfg1 = dataclasses.replace(cfg0, flash_vjp=True)
    params = tmodels.init_params(cfg0, torch.Generator().manual_seed(0), "cpu",
                                 cast=False)
    batch = tmodels.random_batch(cfg0, 2, 16, seed=1, device="cpu")
    grads = []
    for cfg in (cfg0, cfg1):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = tmodels.loss_fn(cfg, live, batch)
        grads.append(torch.autograd.grad(loss, tree_leaves(live)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-3)


def test_flash_vjp_refuses_a_softcap():
    jc, tc = _cfgs(4, 2, 0, attn_logit_softcap=2.0)
    with pytest.raises(NotImplementedError):
        jattn._flash_vjp_fn(jc)
    with pytest.raises(NotImplementedError):
        tattn._flash_vjp_fn(tc)
    q, k, v, _, pos = _inputs(4, 2)
    with pytest.raises(NotImplementedError):
        tattn.flash_attention(tc, *(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(pos), torch.from_numpy(pos))
