"""The recurrent mixers (Mamba, mLSTM, sLSTM) of the port against the
reference's, on the CPU.

Each mixer's ``*_init`` structure, ``*_forward``, ``*_init_state`` and
``*_decode`` (from the initial state and from a random one, over one and
several tokens) on the reference's parameters and the same numpy inputs;
prefill of S tokens plus one decode step against forward over S + 1 for
the reference's ``ARCH_CASES`` cases ``mamba``, ``mlstm``, ``slstm`` and
``hybrid`` (``tests/test_models.py``).  f32 at atol = rtol = 2e-4
(summation order only; the tolerance of ``tests/test_torch_archs.py``).
In bf16 compute the f32 leaves stay f32 under ``cast_for_compute``, and
the mixers agree with the reference's within BF16_TOL of their largest
output (see there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jmodels
import repro.models.ssm as jssm
import repro_torch.models as tmodels
import repro_torch.models.ssm as tssm
from repro.models.config import LayerSpec as JSpec
from repro.models.config import ModelConfig as JConfig
from repro_torch.convert import params_from_jax
from repro_torch.models.config import LayerSpec as TSpec
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.model import F32_LEAVES, cast_for_compute

TOL = dict(atol=2e-4, rtol=2e-4)
MIXERS = ["mamba", "mlstm", "slstm"]
# The f32 parameters of each mixer (the rest is cast to the compute dtype).
F32_OF = {"mamba": {"a_log", "dt_bias"}, "mlstm": {"w_gates", "b_gates"},
          "slstm": {"r_h", "b"}}
# bf16 compute: the two packages round the same bf16 products, but the
# matmuls sum in other orders, so a bf16 rounding (2^-8 relative) can
# land on either side; after the input projection, the recurrence and
# the output projection that is a few units of 2^-8 of the largest
# output (at most 2.2 measured here).  2^-6 allows four.
BF16_TOL = 2.0 ** -6

# tests/test_models.py's ARCH_CASES for the recurrent mixers.
ARCH_CASES = {
    "mamba": dict(pattern=(("mamba", "dense"),), n_heads=4, n_kv_heads=4),
    "mlstm": dict(pattern=(("mlstm", "none"),), tie_embeddings=True),
    "slstm": dict(pattern=(("slstm", "none"),), tie_embeddings=True),
    "hybrid": dict(pattern=(("attn", "dense"), ("mamba", "dense")),
                   n_layers=4),
}


def tiny(**kw):
    """tests/test_models.py's tiny config in both packages."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab_size=128, attn_q_chunk=8, attn_kv_chunk=8,
                compute_dtype="float32")
    base.update(kw)
    pattern = base.pop("pattern", (("attn", "dense"),))
    return (JConfig(pattern=tuple(JSpec(*p) for p in pattern), **base),
            TConfig(pattern=tuple(TSpec(*p) for p in pattern), **base))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _mixer_params(mixer, jc, seed=0):
    """The reference's mixer parameters: (jax tree, numpy tree)."""
    jp = getattr(jssm, f"{mixer}_init")(jax.random.PRNGKey(seed), jc,
                                        jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _random_state(mixer, tc, batch, rng):
    """A state a few steps into a sequence: random carries, sLSTM's n > 0."""
    state = getattr(tssm, f"{mixer}_init_state")(tc, batch, "cpu")
    out = {}
    for k, v in state.items():
        a = rng.normal(0, 0.5, v.shape).astype(np.float32)
        if mixer == "slstm" and k == "n":
            a = np.abs(a) + 0.1
        out[k] = a
    return out


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_draws_the_references_structure(mixer):
    """Leaf names, shapes and dtypes of ``*_init`` equal the reference's:
    the f32 leaves (and Mamba's ``d_skip``, cast at use) are f32 whatever
    ``dtype``, and ``F32_LEAVES`` names the f32 leaves."""
    jc, tc = tiny()
    _, want = _mixer_params(mixer, jc)
    got = getattr(tssm, f"{mixer}_init")(torch.Generator().manual_seed(0),
                                         tc, torch.bfloat16, "cpu")
    assert set(got) == set(want)
    drawn_f32 = F32_OF[mixer] | ({"d_skip"} if mixer == "mamba" else set())
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert v.dtype == (torch.float32 if k in drawn_f32
                           else torch.bfloat16), k
    assert F32_OF[mixer] <= set(F32_LEAVES)


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_values_match_reference(mixer):
    """The deterministic leaves (biases, decay, skip) equal the
    reference's; the random ones have its scale."""
    jc, tc = tiny()
    _, want = _mixer_params(mixer, jc)
    got = getattr(tssm, f"{mixer}_init")(torch.Generator().manual_seed(0),
                                         tc, torch.float32, "cpu")
    for k in ("conv_b", "dt_bias", "a_log", "d_skip", "b_gates", "b"):
        if k in want:
            np.testing.assert_allclose(_np(got[k]), want[k], rtol=1e-6)
    for k in ("w_in", "w_gates", "w_x", "r_h"):
        if k in want:
            assert np.isclose(float(got[k].std()), want[k].std(), rtol=0.2)


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_state_matches_reference(mixer):
    """Shapes, dtype and values: zeros, mLSTM's m and sLSTM's m at -1e30,
    sLSTM's n at 1e-6."""
    jc, tc = tiny()
    want = getattr(jssm, f"{mixer}_init_state")(jc, 3)
    got = getattr(tssm, f"{mixer}_init_state")(tc, 3, "cpu")
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mixer", MIXERS)
def test_forward_matches_reference(mixer):
    jc, tc = tiny()
    jp, tree = _mixer_params(mixer, jc)
    x = np.random.default_rng(1).normal(size=(2, 12, 32)).astype(np.float32)
    want = getattr(jssm, f"{mixer}_forward")(jc, jp, jnp.asarray(x),
                                             jnp.float32)
    got = getattr(tssm, f"{mixer}_forward")(
        tc, {k: _t(v) for k, v in tree.items()}, _t(x), torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("start", ["init", "random"])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_matches_reference(mixer, s, start):
    """``*_decode`` over s tokens from the initial or a random state: the
    output and every leaf of the new state."""
    jc, tc = tiny()
    jp, tree = _mixer_params(mixer, jc)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    if start == "init":
        state = {k: v.numpy() for k, v in getattr(
            tssm, f"{mixer}_init_state")(tc, 2, "cpu").items()}
    else:
        state = _random_state(mixer, tc, 2, rng)
    wy, wstate = getattr(jssm, f"{mixer}_decode")(
        jc, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
        jnp.float32)
    gy, gstate = getattr(tssm, f"{mixer}_decode")(
        tc, {k: _t(v) for k, v in tree.items()}, _t(x),
        {k: _t(v) for k, v in state.items()}, torch.float32)
    np.testing.assert_allclose(_np(gy), np.asarray(wy), **TOL)
    assert set(gstate) == set(wstate)
    for k, v in gstate.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(_np(v), np.asarray(wstate[k]), **TOL,
                                   err_msg=k)


def test_softplus_is_the_references():
    """logaddexp(x, 0), smooth past torch's softplus threshold of 20."""
    x = np.linspace(-60, 60, 2401, dtype=np.float32)
    np.testing.assert_allclose(tssm.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_decode_after_prefill_matches_forward(case):
    """Prefill 16 tokens, decode token 16: the logits the port's and the
    reference's forward over 17 tokens give at position 16; the prefill's
    last logits their position 15."""
    jc, tc = tiny(**ARCH_CASES[case])
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu")
    b, s = 2, 16
    tokens = np.random.default_rng(1).integers(
        0, tc.vocab_size, (b, s + 1)).astype(np.int32)
    want_full, _ = jmodels.forward(jc, jparams, {"tokens": jnp.asarray(tokens)})
    got_full, _ = tmodels.forward(tc, tparams, {"tokens": _t(tokens)})
    np.testing.assert_allclose(_np(got_full), np.asarray(want_full), **TOL)
    last, cache = tmodels.prefill(tc, tparams, {"tokens": _t(tokens[:, :s])},
                                  max_len=s + 4)
    np.testing.assert_allclose(_np(last), np.asarray(want_full[:, s - 1]),
                               **TOL)
    got, _ = tmodels.decode_step(tc, tparams, cache, _t(tokens[:, s:s + 1]),
                                 torch.full((b,), s, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(got_full[:, s]), **TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want_full[:, s]), **TOL)


@pytest.mark.parametrize("mixer", MIXERS)
def test_bf16_keeps_the_recurrent_leaves_f32(mixer):
    """``cast_for_compute`` in bf16 keeps the mixer's f32 leaves f32 (and
    casts the rest), and the mixer then computes what the reference does
    with f32 parameters cast at use, within BF16_TOL of the largest
    output, over a 12-token forward and a decode step."""
    jc, tc = tiny(compute_dtype="bfloat16")
    jp, tree = _mixer_params(mixer, jc)
    params = cast_for_compute(tc, {"mixer": {k: _t(v) for k, v in
                                             tree.items()}})["mixer"]
    for k, v in params.items():
        assert v.dtype == (torch.float32 if k in F32_OF[mixer]
                           else torch.bfloat16), k
    x = np.random.default_rng(3).normal(size=(2, 12, 32)).astype(np.float32)
    want = np.asarray(getattr(jssm, f"{mixer}_forward")(
        jc, jp, jnp.asarray(x), jnp.bfloat16).astype(jnp.float32))
    got = _np(getattr(tssm, f"{mixer}_forward")(tc, params, _t(x),
                                                torch.bfloat16))
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= BF16_TOL * scale
    state = getattr(jssm, f"{mixer}_init_state")(jc, 2)
    wy, _ = getattr(jssm, f"{mixer}_decode")(jc, jp, jnp.asarray(x[:, :1]),
                                             state, jnp.bfloat16)
    gy, _ = getattr(tssm, f"{mixer}_decode")(
        tc, params, _t(x[:, :1]),
        getattr(tssm, f"{mixer}_init_state")(tc, 2, "cpu"), torch.bfloat16)
    wy = np.asarray(wy.astype(jnp.float32))
    assert np.abs(_np(gy) - wy).max() <= BF16_TOL * float(np.abs(wy).max())
