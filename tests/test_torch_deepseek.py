"""deepseek-moe-16b in the port against the reference, on the CPU.

The model adds two features to the slice: shared experts (a dense SwiGLU
of width ``d_ff_expert * n_shared_experts`` beside the routed experts)
and a dense first layer (``first_dense_d_ff``).  Weights cross with
``repro_torch.convert.params_from_jax``; inputs cross as numpy.
Tolerances: 1e-5 for one layer and 2e-4 for the model in f32 (summation
order only; 2e-4 is the reference's own decode-vs-forward tolerance, as
in ``tests/test_torch_model.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.launch.serve as jserve
import repro.models as jmodels
import repro.models.moe as jmoe
import repro_torch.configs as tcfgs
import repro_torch.launch.serve as tserve
import repro_torch.models as tmodels
import repro_torch.models.moe as tmoe
from repro.models.config import LayerSpec as JL
from repro.models.config import ModelConfig as JConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.config import LayerSpec as TL
from repro_torch.models.config import ModelConfig as TConfig

ARCH = "deepseek-moe-16b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def smoke():
    """The 3-layer smoke model in both packages, the same weights."""
    jc, tc = jcfgs.smoke_config(ARCH), tcfgs.smoke_config(ARCH)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu")
    return jc, tc, jparams, tparams


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
def test_config_matches_reference(get):
    want = dataclasses.asdict(getattr(jcfgs, get)(ARCH))
    assert dataclasses.asdict(getattr(tcfgs, get)(ARCH)) == want


def test_full_config_and_scan_units():
    cfg = tcfgs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k,
            cfg.d_ff_expert, cfg.n_shared_experts, cfg.first_dense_d_ff,
            cfg.vocab_size) == (28, 2048, 64, 6, 1408, 2, 10944, 102400)
    assert tmodels.n_scan_units(cfg) == jmodels.n_scan_units(
        jcfgs.get_config(ARCH)) == 27
    smoke = tcfgs.smoke_config(ARCH)
    assert tmodels.n_scan_units(smoke) == 2
    llama = tcfgs.get_config("llama-moe-3.5b")
    assert tmodels.n_scan_units(llama) == llama.n_units == 32


def _moe_cfgs(**kw):
    base = dict(name="m", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128, n_experts=8, top_k=3, d_ff_expert=16,
                n_shared_experts=2, compute_dtype="float32")
    base.update(kw)
    return (JConfig(pattern=(JL("attn", "moe"),), **base),
            TConfig(pattern=(TL("attn", "moe"),), **base))


def test_moe_init_shared_block_matches_reference_shapes():
    jc, tc = _moe_cfgs()
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tc, torch.float32,
                       "cpu")
    assert set(tp) == set(jp)
    assert {k: tuple(v.shape) for k, v in tp["shared"].items()} == \
        {k: tuple(v.shape) for k, v in jp["shared"].items()} == \
        {"w_gate": (32, 32), "w_up": (32, 32), "w_down": (32, 32)}
    # out_proj_init's residual scaling on w_down: std 0.02 / sqrt(2 L).
    std = float(tp["shared"]["w_down"].std())
    assert 0.5 * 0.01 < std < 1.5 * 0.01


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_local_with_shared_experts_matches_reference(capacity_factor):
    jc, tc = _moe_cfgs(capacity_factor=capacity_factor)
    rng = np.random.default_rng(4)
    p = {"router": rng.normal(size=(32, 8)),
         "w_gate": rng.normal(size=(8, 32, 16)) * 0.2,
         "w_up": rng.normal(size=(8, 32, 16)) * 0.2,
         "w_down": rng.normal(size=(8, 16, 32)) * 0.2,
         "shared": {"w_gate": rng.normal(size=(32, 32)) * 0.2,
                    "w_up": rng.normal(size=(32, 32)) * 0.2,
                    "w_down": rng.normal(size=(32, 32)) * 0.2}}
    p = jax.tree.map(lambda v: v.astype(np.float32), p)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    jy, jaux = jmoe.moe_apply_local(jc, jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), jnp.float32)
    ty, taux = tmoe.moe_apply_local(tc, jax.tree.map(_t, p), _t(x),
                                    torch.float32)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(taux["expert_counts"]),
                                  np.asarray(jaux["expert_counts"]))
    # The shared experts are really in the output: without them it moves.
    no_shared = dataclasses.replace(tc, n_shared_experts=0)
    routed, _ = tmoe.moe_apply_local(no_shared, jax.tree.map(_t, p), _t(x),
                                     torch.float32)
    assert float((routed - ty).abs().max()) > 1e-3
    # apply_placement permutes the routed experts only.
    perm = np.random.default_rng(5).permutation(8)
    tp = tmoe.apply_placement(jax.tree.map(_t, p), perm)
    jp = jmoe.apply_placement(jax.tree.map(jnp.asarray, p), perm)
    for k in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(_np(tp["shared"][k]), p["shared"][k])


def test_params_carry_the_first_block_and_shared_experts(smoke):
    jc, tc, jparams, tparams = smoke
    assert len(tparams["layers"]) == 2
    first = tparams["first"]
    assert tuple(first["ffn"]["w_gate"].shape) == (64, tc.first_dense_d_ff)
    np.testing.assert_array_equal(_np(first["ffn"]["w_down"]),
                                  np.asarray(jparams["first"]["ffn"]["w_down"]))
    for u, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(
            _np(layer["ffn"]["shared"]["w_up"]),
            np.asarray(jparams["units"]["b0"]["ffn"]["shared"]["w_up"][u]))


def test_init_params_matches_the_reference_structure():
    """The port draws the reference's tree: the same leaves and shapes."""
    jc, tc = jcfgs.smoke_config(ARCH), tcfgs.smoke_config(ARCH)
    jparams = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    tparams = tmodels.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    carried = params_from_jax(tc, jparams, "cpu")
    shapes = jax.tree.map(lambda v: tuple(v.shape), carried)
    assert jax.tree.map(lambda v: tuple(v.shape), tparams) == shapes


def test_cast_while_drawing_equals_cast_after():
    """``init_params`` casts each block as it is drawn: the values of the
    whole model drawn in f32 and cast after, and casting its result again
    (``cast_for_compute`` is idempotent) changes nothing."""
    f32 = tcfgs.smoke_config(ARCH)
    assert f32.compute_dtype == "float32"
    cfg = dataclasses.replace(f32, compute_dtype="bfloat16")
    early = tmodels.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    late = tmodels.cast_for_compute(cfg, tmodels.init_params(
        f32, torch.Generator().manual_seed(3), "cpu"))
    again = tmodels.cast_for_compute(cfg, tmodels.init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again),
                                                 jax.tree.leaves(early)))
    flat_late, flat_early = jax.tree.leaves(late), jax.tree.leaves(early)
    assert len(flat_late) == len(flat_early)
    for a, b in zip(flat_late, flat_early):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert early["first"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert early["layers"][0]["ffn"]["router"].dtype == torch.float32


def test_smoke_model_matches_reference(smoke):
    """Router counts ((2, E): no row for the dense first layer) equal,
    forward, prefill and three decode steps within 2e-4, greedy tokens
    equal."""
    jc, tc, jparams, tparams = smoke
    calib_j = jmodels.random_batch(jc, 4, 8, seed=7)
    calib_t = tmodels.random_batch(tc, 4, 8, seed=7, device="cpu")
    jl, _, jcounts = jmodels.forward(jc, jparams, calib_j,
                                     return_router_stats=True)
    tl, _, tcounts = tmodels.forward(tc, tparams, calib_t,
                                     return_router_stats=True)
    assert tuple(tcounts.shape) == (2, tc.n_experts)
    np.testing.assert_array_equal(_np(tcounts), np.asarray(jcounts))
    assert (_np(tcounts).sum(axis=1) > 0).all()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)

    tokens = np.asarray(jmodels.random_batch(jc, 4, 8, seed=0)["tokens"])
    jlog, jcache = jmodels.prefill(jc, jparams, {"tokens": jnp.asarray(tokens)},
                                   max_len=12)
    tlog, tcache = tmodels.prefill(tc, tparams, {"tokens": _t(tokens)},
                                   max_len=12)
    assert set(tcache) == {"first", "layers"}
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4,
                               rtol=2e-4)
    jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    for step in range(3):
        np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))
        pos = np.full((4,), 8 + step, np.int32)
        jlog, jcache = jmodels.decode_step(jc, jparams, jcache, jtok,
                                           jnp.asarray(pos))
        tlog, tcache = tmodels.decode_step(tc, tparams, tcache, ttok, _t(pos))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4,
                                   rtol=2e-4)
        jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(_np(ttok), np.asarray(jtok))


ARGV = ["--smoke", "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
        "--decode-tokens", "3"]


def test_serve_smoke_dispatch_cost_is_the_references(smoke, monkeypatch,
                                                     capsys):
    """``serve --smoke --arch deepseek-moe-16b`` on the reference's weights:
    the placement over the 2 MoE units gives the reference's dispatch cost
    bit for bit, and step 4 the reference's space latency."""
    jc, tc, jparams, _ = smoke
    np_params = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            tc, np_params, device))
    got = tserve.main(ARGV + ["--device", "cpu", "--space-sim"])
    lines = capsys.readouterr().out
    want = jserve.main(ARGV + ["--space-sim"])
    assert set(got) == set(want)
    assert got["dispatch_cost"] == want["dispatch_cost"]
    for k, v in want["space_latency_s"].items():
        assert np.isclose(got["space_latency_s"][k], v, rtol=1e-6)
    assert "[placement] expected dispatch cost: theorem1=" in lines


def test_serve_places_every_moe_unit():
    """The placement runs over the MoE units only: one plan a unit, the
    experts of each unit permuted in place, the dense first block and the
    shared experts untouched."""
    tc = tcfgs.smoke_config(ARCH)
    params = tmodels.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    counts = tserve.calibrate_router_stats(
        tc, params, tmodels.random_batch(tc, 4, 8, seed=7, device="cpu"))
    assert counts.shape == (2, tc.n_experts)
    first = params["first"]
    before = [dict(layer["ffn"]) for layer in params["layers"]]
    placed, plans, costs = tserve.plan_and_apply_placement(tc, params, counts)
    assert placed is params and placed["first"] is first
    assert len(plans) == 2 and costs["theorem1"] <= costs["identity"]
    for plan, ffn, layer in zip(plans, before, placed["layers"]):
        perm = torch.as_tensor(plan.expert_perm)
        assert torch.equal(layer["ffn"]["w_up"], ffn["w_up"][perm])
        assert torch.equal(layer["ffn"]["router"], ffn["router"][:, perm])
        assert layer["ffn"]["shared"] is ffn["shared"]


@pytest.mark.parametrize("layers,experts,want", [
    (2, 8, 16),      # smoke sizes: the reference's 12 x 16 world
    (32, 8, 32),     # llama-moe-3.5b: one satellite a layer
    (27, 64, 162),   # deepseek-moe-16b: 6 x 12 = 72 >= 65 a subnet
    (32, 40, 128),   # granite-moe-3b-a800m: 4 x 12 = 48 >= 41
    (16, 11, 16), (16, 12, 32),
])
def test_step4_world_holds_every_layers_experts(layers, experts, want):
    assert tserve.plane_sats(layers, experts, 12) == want
    per_subnet = 12 * (want // layers)
    assert per_subnet >= experts + 1
