"""EP slotting in the port against the reference, on the CPU.

``make_slotting`` on the reference's cases; ``slotted_weights`` and
``virtual_indices`` bitwise; ``moe_apply_local`` on a slotted stack
(fragments, dummy experts, both) at 1e-5 in f32 (summation order only);
the slotted smoke models of llama-moe-3.5b and granite-moe-3b-a800m
through ``params_from_jax`` at 2e-4 (as ``tests/test_torch_archs.py``);
and placement on a slotted stack, which fails in both packages.
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
from test_torch_archs import check_smoke_model


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("e,s,frag,e_pad", [
    (8, 16, 2, 8),        # llama-moe: fragment
    (40, 16, 1, 48),      # granite: pad with dummies
    (6, 16, 2, 8),        # pad then fragment
    (64, 16, 1, 64),      # deepseek: already divisible
    (16, 16, 1, 16),      # jamba: exact
])
def test_make_slotting_matches_reference(e, s, frag, e_pad):
    got, want = tmoe.make_slotting(e, s), jmoe.make_slotting(e, s)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.frag, got.e_pad) == (frag, e_pad)
    assert got.n_virtual == want.n_virtual and got.n_virtual % s == 0


def _cfgs(e, k, slots=16, dff=32, **kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128, n_experts=e, top_k=k,
                d_ff_expert=dff, compute_dtype="float32", moe_slotting=True,
                moe_ep_slots=slots)
    base.update(kw)
    return (JConfig(pattern=(JL("attn", "moe"),), **base),
            TConfig(pattern=(TL("attn", "moe"),), **base))


def _stacks(e, d=32, f=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) * 0.2).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) * 0.2).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) * 0.2).astype(np.float32)}


# (experts, slots): fragments, dummy experts, dummies then fragments.
CASES = {"fragment": (8, 16), "padding": (40, 16), "pad+fragment": (6, 16)}


@pytest.mark.parametrize("case", list(CASES))
def test_slotted_weights_and_virtual_indices_bitwise(case):
    e, slots = CASES[case]
    p = _stacks(e)
    sl_t, sl_j = tmoe.make_slotting(e, slots), jmoe.make_slotting(e, slots)
    got = tmoe.slotted_weights(_t(p["w_gate"]), _t(p["w_up"]),
                               _t(p["w_down"]), sl_t)
    want = jmoe.slotted_weights(jnp.asarray(p["w_gate"]), jnp.asarray(p["w_up"]),
                                jnp.asarray(p["w_down"]), sl_j)
    for g, w in zip(got, want, strict=True):
        assert g.is_contiguous()
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert int(got[0][e * sl_t.frag:].abs().sum()) == 0   # dummies are zeros
    idx = np.random.default_rng(1).integers(0, e, (11, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tmoe.virtual_indices(_t(idx).long(), sl_t)),
        np.asarray(jmoe.virtual_indices(jnp.asarray(idx), sl_j)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_local_slotted_matches_reference(case, capacity_factor):
    """Dispatch over V virtual buckets, fragments summed before the top-K
    weights; drops as in the reference at the tight capacity too."""
    e, slots = CASES[case]
    jc, tc = _cfgs(e, 3, slots, capacity_factor=capacity_factor)
    p = _stacks(e)
    sl = tmoe.slotting_for(tc)
    ws = tmoe.slotted_weights(_t(p["w_gate"]), _t(p["w_up"]),
                              _t(p["w_down"]), sl)
    slotted = dict(p, **{k: _np(w) for k, w in
                         zip(("w_gate", "w_up", "w_down"), ws)})
    x = np.random.default_rng(4).normal(size=(2, 8, 32)).astype(np.float32)
    jy, jaux = jmoe.moe_apply_local(jc, jax.tree.map(jnp.asarray, slotted),
                                    jnp.asarray(x), jnp.float32)
    ty, taux = tmoe.moe_apply_local(tc, jax.tree.map(_t, slotted), _t(x),
                                    torch.float32)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(taux["expert_counts"]),
                                  np.asarray(jaux["expert_counts"]))


def test_fragments_equal_the_whole_expert():
    """At a capacity that drops nothing, the slotted layer equals the
    canonical one on the same weights (the reference's own check)."""
    _, tc = _cfgs(8, 2, capacity_factor=8.0)
    p = _stacks(8)
    ws = tmoe.slotted_weights(_t(p["w_gate"]), _t(p["w_up"]),
                              _t(p["w_down"]), tmoe.slotting_for(tc))
    x = _t(np.random.default_rng(5).normal(size=(2, 16, 32)).astype(np.float32))
    whole, _ = tmoe.moe_apply_local(dataclasses.replace(tc, moe_slotting=False),
                                    jax.tree.map(_t, p), x, torch.float32)
    parts, _ = tmoe.moe_apply_local(
        tc, dict(jax.tree.map(_t, p), w_gate=ws[0], w_up=ws[1], w_down=ws[2]),
        x, torch.float32)
    np.testing.assert_allclose(_np(parts), _np(whole), atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_init_draws_then_slots(case):
    e, slots = CASES[case]
    _, tc = _cfgs(e, 2, slots)
    sl = tmoe.slotting_for(tc)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), tc, torch.float32,
                      "cpu")
    canon = tmoe.moe_init(torch.Generator().manual_seed(0),
                          dataclasses.replace(tc, moe_slotting=False),
                          torch.float32, "cpu")
    want = tmoe.slotted_weights(canon["w_gate"], canon["w_up"],
                                canon["w_down"], sl)
    assert tuple(p["router"].shape) == (32, e)     # router stays expert-level
    for name, w in zip(("w_gate", "w_up", "w_down"), want):
        assert torch.equal(p[name], w)
    assert p["w_gate"].shape[0] == sl.n_virtual


@pytest.mark.parametrize("arch", ["llama-moe-3.5b", "granite-moe-3b-a800m"])
def test_slotted_smoke_model_matches_reference(arch):
    jc = dataclasses.replace(jcfgs.smoke_config(arch), moe_slotting=True)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), moe_slotting=True)
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    tparams = params_from_jax(tc, tree, "cpu")
    drawn = tmodels.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    shape = lambda v: tuple(v.shape)  # noqa: E731
    assert jax.tree.map(shape, tparams) == jax.tree.map(shape, drawn)
    sl = tmoe.slotting_for(tc)
    assert tuple(tparams["layers"][0]["ffn"]["w_down"].shape) == \
        (sl.n_virtual, tc.d_ff_expert // sl.frag, tc.d_model)
    check_smoke_model(jc, tc, jax.tree.map(jnp.asarray, tree), tparams)


def test_placement_on_a_slotted_stack_fails_in_both_packages():
    """The reference permutes the V virtual rows by an E-long permutation
    and fails in the expert einsum; the port refuses at the placement."""
    arch = "llama-moe-3.5b"
    jc = dataclasses.replace(jcfgs.smoke_config(arch), moe_slotting=True)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), moe_slotting=True)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    counts = jserve.calibrate_router_stats(
        jc, jparams, jmodels.random_batch(jc, 4, 8, seed=7))
    placed, _, _ = jserve.plan_and_apply_placement(jc, jparams, counts)
    prompt = {"tokens": jmodels.random_batch(jc, 2, 8, seed=0)["tokens"]}
    with pytest.raises(ValueError):
        jmodels.prefill(jc, placed, prompt, max_len=12)

    tparams = tmodels.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    tcounts = tserve.calibrate_router_stats(
        tc, tparams, tmodels.random_batch(tc, 4, 8, seed=7, device="cpu"))
    with pytest.raises(ValueError, match="16 rows for 8 experts"):
        tserve.plan_and_apply_placement(tc, tparams, tcounts)
    with pytest.raises(ValueError, match="V != E"):
        tmoe.apply_placement(tparams["layers"][0]["ffn"], np.arange(8))
    padded = dataclasses.replace(tcfgs.smoke_config("granite-moe-3b-a800m"),
                                 moe_slotting=True, moe_ep_slots=6)
    ffn = tmoe.moe_init(torch.Generator().manual_seed(0), padded,
                        torch.float32, "cpu")
    with pytest.raises(ValueError, match="12 rows for 8 experts"):
        tmoe.apply_placement(ffn, np.arange(8))
