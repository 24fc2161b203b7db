"""Port model and placement math vs the JAX reference, on the CPU.

Both packages get the same numpy inputs (weights carried across with
``repro_torch.convert.params_from_jax``); data crosses only as numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.core as jcore
import repro.models as jmodels
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.moe as jmoe
import repro_torch.configs as tcfgs
import repro_torch.core as tcore
import repro_torch.models as tmodels
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers
import repro_torch.models.moe as tmoe
from repro.models.config import ModelConfig as JConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.config import ModelConfig as TConfig

ARCH = "llama-moe-3.5b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tiny(**kw):
    """The same small config in both packages."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128, attn_q_chunk=8, attn_kv_chunk=8,
                compute_dtype="float32")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


# --------------------------------------------------------------------- #
# Configs
# --------------------------------------------------------------------- #


def test_configs_match_reference():
    for get in ("get_config", "smoke_config"):
        want = dataclasses.asdict(getattr(jcfgs, get)(ARCH))
        got = dataclasses.asdict(getattr(tcfgs, get)(ARCH))
        assert got == want, get
    full = tcfgs.get_config(ARCH)
    assert (full.d_model, full.n_layers, full.n_experts, full.top_k,
            full.d_ff_expert) == (4096, 32, 8, 2, 1376)


# --------------------------------------------------------------------- #
# Layers and attention (f32; tolerances: summation order only)
# --------------------------------------------------------------------- #


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32), (2, 5))
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm({"scale": _t(scale)}, _t(x))),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(_t(x), _t(pos), 10000.0)),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hkv,window", [(2, 0), (4, 0), (2, 5)])
def test_attention_forward_matches_reference(hkv, window):
    jc, tc = tiny(n_kv_heads=hkv, sliding_window=window)
    rng = np.random.default_rng(1)
    params = {"w_q": rng.normal(size=(32, jc.q_dim)) * 0.2,
              "w_k": rng.normal(size=(32, jc.kv_dim)) * 0.2,
              "w_v": rng.normal(size=(32, jc.kv_dim)) * 0.2,
              "w_o": rng.normal(size=(jc.q_dim, 32)) * 0.2}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = jattn.attention_forward(jc, {k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(x), jnp.asarray(pos), jnp.float32)
    got = tattn.attention_forward(tc, {k: _t(v) for k, v in params.items()},
                                  _t(x), _t(pos), torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dense_model_matches_reference():
    """The dense-FFN block (``ffn_apply``) through forward, prefill and two
    decode steps, weights carried across."""
    jc, tc = tiny()
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(1))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, 128, (2, 12)).astype(np.int32)
    jl, _ = jmodels.forward(jc, jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tmodels.forward(tc, tparams, {"tokens": _t(tokens)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    _, jcache = jmodels.prefill(jc, jparams, {"tokens": jnp.asarray(tokens[:, :10])},
                                max_len=14)
    _, tcache = tmodels.prefill(tc, tparams, {"tokens": _t(tokens[:, :10])},
                                max_len=14)
    for s in (10, 11):
        pos = np.full((2,), s, np.int32)
        jlog, jcache = jmodels.decode_step(jc, jparams, jcache,
                                           jnp.asarray(tokens[:, s:s + 1]),
                                           jnp.asarray(pos))
        tlog, tcache = tmodels.decode_step(tc, tparams, tcache,
                                           _t(tokens[:, s:s + 1]), _t(pos))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_allclose(_np(tlog), _np(tl[:, s]), atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------- #
# MoE: routing, dispatch (index outputs equal), layer (values 1e-5)
# --------------------------------------------------------------------- #


def _moe_cfgs(**kw):
    from repro.models.config import LayerSpec as JL
    from repro_torch.models.config import LayerSpec as TL
    base = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128, n_experts=8, top_k=2, d_ff_expert=16,
                compute_dtype="float32")
    base.update(kw)
    return (JConfig(pattern=(JL("attn", "moe"),), **base),
            TConfig(pattern=(TL("attn", "moe"),), **base))


def test_route_matches_reference():
    jc, tc = _moe_cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    router = rng.normal(size=(32, 8)).astype(np.float32)
    jw, ji, jaux = jmoe.route(jc, jnp.asarray(router), jnp.asarray(x))
    tw, ti, taux = tmoe.route(tc, _t(router), _t(x))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(taux["expert_counts"]),
                                  np.asarray(jaux["expert_counts"]))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5, rtol=1e-5)
    for key in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(_np(taux[key]), np.asarray(jaux[key]),
                                   atol=1e-5, rtol=1e-5)


def test_route_breaks_ties_toward_lower_index():
    """Equal gate scores: lax.top_k takes the lower expert ids; so must the
    port (a stable descending sort)."""
    jc, tc = _moe_cfgs()
    x = np.zeros((3, 32), np.float32)                  # every logit equal
    router = np.random.default_rng(3).normal(size=(32, 8)).astype(np.float32)
    _, ji, _ = jmoe.route(jc, jnp.asarray(router), jnp.asarray(x))
    _, ti, _ = tmoe.route(tc, _t(router), _t(x))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(ti), np.tile([0, 1], (3, 1)))


@pytest.mark.parametrize("t,cap", [(37, 3), (4, 2), (16, 8)])
def test_dispatch_indices_match_reference(t, cap):
    idx = np.random.default_rng(t).integers(0, 8, size=(t, 2)).astype(np.int32)
    want = jmoe.dispatch_indices(jnp.asarray(idx), 8, cap)
    got = tmoe.dispatch_indices(_t(idx), 8, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_dispatch_drops_the_same_copies_as_reference():
    idx = np.zeros((6, 2), np.int32)                   # all copies -> expert 0
    idx[:, 1] = 1
    _, _, _, jkept = jmoe.dispatch_indices(jnp.asarray(idx), 4, 2)
    _, _, _, tkept = tmoe.dispatch_indices(_t(idx), 4, 2)
    np.testing.assert_array_equal(_np(tkept), np.asarray(jkept))
    assert _np(tkept).sum() == 4                       # 2 per expert kept


@pytest.mark.parametrize("t", [1, 4, 128, 200])
def test_capacity_matches_reference(t):
    jc, tc = _moe_cfgs()
    assert tmoe.capacity(tc, t, 8) == jmoe.capacity(jc, t, 8)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_local_matches_reference(capacity_factor):
    jc, tc = _moe_cfgs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(4)
    p = {"router": rng.normal(size=(32, 8)),
         "w_gate": rng.normal(size=(8, 32, 16)) * 0.2,
         "w_up": rng.normal(size=(8, 32, 16)) * 0.2,
         "w_down": rng.normal(size=(8, 16, 32)) * 0.2}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    jy, jaux = jmoe.moe_apply_local(jc, {k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), jnp.float32)
    ty, taux = tmoe.moe_apply_local(tc, {k: _t(v) for k, v in p.items()},
                                    _t(x), torch.float32)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(taux["expert_counts"]),
                                  np.asarray(jaux["expert_counts"]))
    perm = np.random.default_rng(5).permutation(8)
    jp = jmoe.apply_placement({k: jnp.asarray(v) for k, v in p.items()}, perm)
    tp = tmoe.apply_placement({k: _t(v) for k, v in p.items()}, perm)
    for k in p:
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))


# --------------------------------------------------------------------- #
# Placement chain: host numpy, bitwise
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed,skew,k", [(0, 0.0, 2), (1, 2.0, 2), (2, 1.0, 3),
                                         (3, 4.0, 1)])
def test_placement_chain_is_bitwise(seed, skew, k):
    rng = np.random.default_rng(seed)
    w = rng.random(8) ** (1 + skew) + 1e-3
    for name in ("esp", "esp_prefix_table"):
        np.testing.assert_array_equal(getattr(tcore, name)(w, k),
                                      getattr(jcore.activation, name)(w, k))
    np.testing.assert_array_equal(tcore.activation_probs(w, k),
                                  jcore.activation_probs(w, k))
    tau = rng.random(8)
    np.testing.assert_array_equal(tcore.theorem1_assignment(w, tau),
                                  jcore.theorem1_assignment(w, tau))
    order = rng.permutation(8)
    assert tcore.layer_latency_closed_form(np.sort(tau), w, order, k) \
        == jcore.layer_latency_closed_form(np.sort(tau), w, order, k)
    for ring in ((8,), (4,), (2, 4)):
        jring, tring = jcore.TorusSpec(shape=ring), tcore.TorusSpec(shape=ring)
        jplan = jcore.plan_expert_devices(w, k, jring, bytes_per_token=128.0)
        tplan = tcore.plan_expert_devices(w, k, tring, bytes_per_token=128.0)
        jid = jcore.identity_plan(8, jring, bytes_per_token=128.0)
        tid = tcore.identity_plan(8, tring, bytes_per_token=128.0)
        for jp_, tp_ in ((jplan, tplan), (jid, tid)):
            np.testing.assert_array_equal(tp_.expert_perm, jp_.expert_perm)
            np.testing.assert_array_equal(tp_.device_cost_s, jp_.device_cost_s)
            assert tp_.experts_per_device == jp_.experts_per_device
            assert tcore.expected_dispatch_cost(tp_, w, k) \
                == jcore.expected_dispatch_cost(jp_, w, k)


# --------------------------------------------------------------------- #
# The slice: weights carried across, forward / prefill / decode
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("pallas_decode", [False, True])
def test_slice_matches_reference(pallas_decode):
    """llama-moe-3.5b at smoke size, f32: router counts and greedy tokens
    equal, logits within 2e-4 (the reference's own decode-vs-forward
    tolerance).  With ``use_pallas_decode`` the reference runs its Pallas
    decode kernel in interpret mode and the port its decode_attention op."""
    jc = dataclasses.replace(jcfgs.smoke_config(ARCH),
                             use_pallas_decode=pallas_decode)
    tc = dataclasses.replace(tcfgs.smoke_config(ARCH),
                             use_pallas_decode=pallas_decode)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu")

    calib_j = jmodels.random_batch(jc, 4, 8, seed=7)
    calib_t = tmodels.random_batch(tc, 4, 8, seed=7, device="cpu")
    np.testing.assert_array_equal(_np(calib_t["tokens"]),
                                  np.asarray(calib_j["tokens"]))
    jl, _, jcounts = jmodels.forward(jc, jparams, calib_j, return_router_stats=True)
    tl, _, tcounts = tmodels.forward(tc, tparams, calib_t, return_router_stats=True)
    np.testing.assert_array_equal(_np(tcounts), np.asarray(jcounts))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)

    prompt_j = {"tokens": jmodels.random_batch(jc, 4, 8, seed=0)["tokens"]}
    prompt_t = {"tokens": tmodels.random_batch(tc, 4, 8, seed=0, device="cpu")["tokens"]}
    jlog, jcache = jmodels.prefill(jc, jparams, prompt_j, max_len=13)
    tlog, tcache = tmodels.prefill(tc, tparams, prompt_t, max_len=13)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4, rtol=2e-4)
    jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    for step in range(4):
        np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))
        pos = np.full((4,), 8 + step, np.int32)
        jlog, jcache = jmodels.decode_step(jc, jparams, jcache, jtok, jnp.asarray(pos))
        tlog, tcache = tmodels.decode_step(tc, tparams, tcache, ttok, _t(pos))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4, rtol=2e-4)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))


def test_cast_for_compute_keeps_router_and_norms_f32():
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH), compute_dtype="bfloat16")
    params = tmodels.cast_for_compute(
        cfg, tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    layer = params["layers"][0]
    assert layer["ffn"]["router"].dtype == torch.float32
    assert layer["norm1"]["scale"].dtype == torch.float32
    assert params["final_norm"]["scale"].dtype == torch.float32
    for w in (layer["ffn"]["w_gate"], layer["mixer"]["w_q"], params["embed"],
              params["head"]):
        assert w.dtype == torch.bfloat16
