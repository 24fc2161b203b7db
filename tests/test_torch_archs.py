"""Every architecture of the reference in the port, on the CPU.

Configs field for field and the registry; each smoke model on the
reference's weights (``repro_torch.convert.params_from_jax``): forward,
prefill and three decode steps, with the stub frontends' embeddings where
the model takes them, at atol = rtol = 2e-4 in f32 (summation order only;
the tolerance of ``tests/test_torch_deepseek.py``), the recurrent
xlstm-350m and the hybrid jamba-1.5-large-398b among them; qwen2.5-3b's
QKV bias; a vocabulary that is not a multiple of 128;
granite-moe-3b-a800m's serve at smoke size against the reference's, and
the EP ring that places its 40 experts at full size, where the
reference's raises.
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
import repro_torch.configs as tcfgs
import repro_torch.launch.serve as tserve
import repro_torch.models as tmodels
from repro_torch.convert import params_from_jax

NEW_ARCHS = ["granite-moe-3b-a800m", "qwen2.5-3b", "smollm-135m",
             "minicpm-2b", "llava-next-mistral-7b", "musicgen-medium",
             "mistral-large-123b"]
SSM_ARCHS = ["jamba-1.5-large-398b", "xlstm-350m"]
TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == jnp.bfloat16:           # numpy has no bf16: cross as bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(jc, tc, seed=0, tweak=None):
    """The reference's weights for ``jc`` in both packages (``tweak`` edits
    the numpy tree before either sees it)."""
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(seed)))
    if tweak is not None:
        tree = tweak(tree)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tc, tree, "cpu")


@pytest.mark.parametrize("get", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", NEW_ARCHS + SSM_ARCHS)
def test_config_matches_reference(arch, get):
    want = dataclasses.asdict(getattr(jcfgs, get)(arch))
    assert dataclasses.asdict(getattr(tcfgs, get)(arch)) == want


def test_registry_is_the_references_without_ssm_archs():
    """The registry is now the reference's whole (the SSM architectures
    included, in its order), and so are ``ASSIGNED``, ``list_archs``,
    ``SHAPES`` and ``shape_applies``; ``get_config`` raises only for a
    name the reference does not know either."""
    assert list(tcfgs.REGISTRY) == list(jcfgs.REGISTRY)
    assert tcfgs.ASSIGNED == jcfgs.ASSIGNED
    for paper in (True, False):
        assert tcfgs.list_archs(paper) == jcfgs.list_archs(paper)
    for arch in SSM_ARCHS:
        assert any(s.mixer != "attn" for s in tcfgs.get_config(arch).pattern)
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfgs.SHAPES.items()}
    for arch in tcfgs.REGISTRY:
        for name in tcfgs.SHAPES:
            assert tcfgs.shape_applies(tcfgs.get_config(arch),
                                       tcfgs.SHAPES[name]) == \
                jcfgs.shape_applies(jcfgs.get_config(arch), jcfgs.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", NEW_ARCHS + SSM_ARCHS)
def test_carried_params_have_init_params_structure(arch):
    """``params_from_jax`` gives exactly the tree the port draws: tied
    embeddings without ``head``, qwen's bias leaves, granite's stacks,
    blocks without ``norm2`` and ``ffn`` (xlstm) and the recurrent f32
    leaves."""
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    _, carried = _both(jc, tc)
    drawn = tmodels.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    shape = lambda v: (tuple(v.shape), v.dtype)  # noqa: E731
    assert jax.tree.map(shape, carried) == jax.tree.map(shape, drawn)
    assert ("head" in drawn) == (not tc.tie_embeddings)
    assert ("b_q" in drawn["layers"][0]["mixer"]) == tc.qkv_bias


def _run_reference(jc, jparams, prompt, decode_embeds):
    logits, cache = jmodels.prefill(jc, jparams, prompt, max_len=12)
    steps = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for step in range(3):
        pos = jnp.full((4,), 8 + step, jnp.int32)
        emb = None if decode_embeds is None else jnp.asarray(decode_embeds[step])
        logits, cache = jmodels.decode_step(jc, jparams, cache, tok, pos,
                                            embeds=emb)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return steps, toks


def _run_port(tc, tparams, prompt, decode_embeds):
    logits, cache = tmodels.prefill(tc, tparams, prompt, max_len=12)
    steps = [_np(logits)]
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks = [_np(tok)]
    for step in range(3):
        pos = torch.full((4,), 8 + step, dtype=torch.int32)
        emb = None if decode_embeds is None else _t(decode_embeds[step])
        logits, cache = tmodels.decode_step(tc, tparams, cache, tok, pos,
                                            embeds=emb)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        steps.append(_np(logits))
        toks.append(_np(tok))
    return steps, toks


def check_smoke_model(jc, tc, jparams, tparams):
    """Forward (with router counts for MoE), prefill and three decode steps
    against the reference; an audio model decodes on frame embeddings."""
    jb = jmodels.random_batch(jc, 4, 8, seed=0)
    tb = tmodels.random_batch(tc, 4, 8, seed=0, device="cpu")
    assert sorted(tb) == sorted(jb)
    jl, jaux = jmodels.forward(jc, jparams, jb)
    tl, taux = tmodels.forward(tc, tparams, tb)
    assert tuple(tl.shape) == (4, 8, tc.padded_vocab)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if tc.has_moe:
        _, _, jcounts = jmodels.forward(jc, jparams, jb,
                                        return_router_stats=True)
        _, _, tcounts = tmodels.forward(tc, tparams, tb,
                                        return_router_stats=True)
        np.testing.assert_array_equal(_np(tcounts), np.asarray(jcounts))

    decode_embeds = None
    if tc.frontend == "audio":
        decode_embeds = np.random.default_rng(1).normal(
            0, 1, (3, 4, 1, tc.d_model)).astype(np.float32)
    jsteps, jtoks = _run_reference(
        jc, jparams, {k: v for k, v in jb.items() if k != "labels"},
        decode_embeds)
    tsteps, ttoks = _run_port(
        tc, tparams, {k: v for k, v in tb.items() if k != "labels"},
        decode_embeds)
    for got, want in zip(tsteps, jsteps, strict=True):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(ttoks, jtoks, strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", NEW_ARCHS + SSM_ARCHS)
def test_smoke_model_matches_reference(arch):
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    check_smoke_model(jc, tc, *_both(jc, tc))


def _random_bias(tree):
    rng = np.random.default_rng(2)
    for name in ("b_q", "b_k", "b_v"):
        leaf = tree["units"]["b0"]["mixer"][name]
        tree["units"]["b0"]["mixer"][name] = \
            rng.normal(0, 0.5, leaf.shape).astype(leaf.dtype)
    return tree


def test_qkv_bias_matches_reference():
    """qwen2.5-3b's QKV bias (zeros at init) with random values: the port
    adds it as the reference does, and it moves the logits."""
    arch = "qwen2.5-3b"
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    assert tc.qkv_bias
    jparams, tparams = _both(jc, tc, tweak=_random_bias)
    assert float(tparams["layers"][1]["mixer"]["b_k"].abs().max()) > 0.1
    check_smoke_model(jc, tc, jparams, tparams)
    tb = tmodels.random_batch(tc, 4, 8, seed=0, device="cpu")
    _, zero = _both(jc, tc)
    with_bias, _ = tmodels.forward(tc, tparams, tb)
    without, _ = tmodels.forward(tc, zero, tb)
    assert float((with_bias - without).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_vocab_not_a_multiple_of_128(arch):
    """vocab_size = 509 pads to 512 in both packages; token draws stay
    below 509, logits cover the padded columns (unmasked, as in the
    reference)."""
    jc = dataclasses.replace(jcfgs.smoke_config(arch), vocab_size=509,
                             vocab_pad_multiple=128)
    tc = dataclasses.replace(tcfgs.smoke_config(arch), vocab_size=509,
                             vocab_pad_multiple=128)
    assert tc.padded_vocab == jc.padded_vocab == 512
    jparams, tparams = _both(jc, tc)
    assert tuple(tparams["embed"].shape) == (512, tc.d_model)
    tb = tmodels.random_batch(tc, 4, 8, seed=0, device="cpu")
    assert int(tb["tokens"].max()) < 509
    check_smoke_model(jc, tc, jparams, tparams)


def test_serve_smoke_granite_is_the_references(monkeypatch, capsys):
    """``serve --smoke --arch granite-moe-3b-a800m --space-sim`` on the
    reference's weights: steps 1-2 place its experts at the reference's
    dispatch cost bit for bit, and step 4 gives the reference's space
    latency (the smoke model's 2 layers fit the reference's 12 x 16)."""
    arch = "granite-moe-3b-a800m"
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            tc, tree, device))
    argv = ["--smoke", "--arch", arch, "--batch", "2", "--prompt-len", "8",
            "--decode-tokens", "3", "--space-sim"]
    got = tserve.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out
    want = jserve.main(argv)
    assert set(got) == set(want)
    assert got["dispatch_cost"] == want["dispatch_cost"]
    for k, v in want["space_latency_s"].items():
        assert np.isclose(got["space_latency_s"][k], v, rtol=1e-6)
    assert "[placement] expected dispatch cost: theorem1=" in lines


@pytest.mark.parametrize("e,want", [(8, 8), (16, 16), (64, 16), (48, 16),
                                    (40, 10), (6, 6), (18, 9)])
def test_ep_ring_divides_the_experts(e, want):
    """Where ``min(16, E)`` divides E the ring is the reference's; else
    the largest divisor of E below it."""
    assert tserve.ep_ring_devices(e) == want
    assert e % want == 0


def test_placement_of_forty_experts():
    """granite-moe-3b-a800m's 40 experts (top-8) at smoke width: the
    reference's 16-device ring raises in ``plan_expert_devices``; the
    port's serve places them on a ring of 10."""
    jc = dataclasses.replace(jcfgs.smoke_config("granite-moe-3b-a800m"),
                             n_experts=40, top_k=8)
    tc = dataclasses.replace(tcfgs.smoke_config("granite-moe-3b-a800m"),
                             n_experts=40, top_k=8)
    jparams, tparams = _both(jc, tc)
    counts = tserve.calibrate_router_stats(
        tc, tparams, tmodels.random_batch(tc, 4, 8, seed=7, device="cpu"))
    np.testing.assert_array_equal(counts, jserve.calibrate_router_stats(
        jc, jparams, jmodels.random_batch(jc, 4, 8, seed=7)))
    with pytest.raises(ValueError, match="not divisible by"):
        jserve.plan_and_apply_placement(jc, jparams, counts)
    before = tparams["layers"][0]["ffn"]["w_up"].clone()
    _, plans, costs = tserve.plan_and_apply_placement(tc, tparams, counts)
    assert len(plans) == 2 and plans[0].experts_per_device == 4
    assert costs["theorem1"] <= costs["identity"]
    perm = torch.as_tensor(plans[0].expert_perm)
    assert sorted(perm.tolist()) == list(range(40))
    assert torch.equal(tparams["layers"][0]["ffn"]["w_up"], before[perm])
