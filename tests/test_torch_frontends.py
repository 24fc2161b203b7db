"""The stub vision/audio frontends in the port against the reference, on
the CPU.

``frontend_split``, ``batch_specs`` (meta tensors where the reference
gives ``ShapeDtypeStruct``s) and ``random_batch`` bitwise; the bf16 cast
of the f64 draws at f32 ties; ``make_serve_step`` with ``embeds``; and
serve at smoke size for a dense, a vision and an audio architecture,
whose greedy tokens equal the reference's serve loop on the same weights
(logits at 2e-4 in f32, as ``tests/test_torch_archs.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.launch.serve as jserve
import repro.models as jmodels
import repro.models.frontends as jfront
import repro_torch.configs as tcfgs
import repro_torch.launch.serve as tserve
import repro_torch.models as tmodels
import repro_torch.models.frontends as tfront
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import Parallel
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_serve_step as tmake_serve_step

ARCHS = {"dense": "qwen2.5-3b", "vision": "llava-next-mistral-7b",
         "audio": "musicgen-medium"}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _bits(x) -> np.ndarray:
    """Raw bits of a tensor or array (bf16 as uint16)."""
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) \
        and x.dtype == torch.bfloat16 else np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("seq_len", [1, 8, 33, 1152, 4096])
@pytest.mark.parametrize("kind", list(ARCHS))
def test_frontend_split_matches_reference(kind, seq_len):
    arch = ARCHS[kind]
    got = tfront.frontend_split(tcfgs.get_config(arch), seq_len)
    assert got == jfront.frontend_split(jcfgs.get_config(arch), seq_len)
    assert sum(got) == seq_len
    assert tfront.VISION_TOKENS == jfront.VISION_TOKENS == 576


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_batch_specs_match_reference(kind, dtype):
    jdt, tdt = DTYPES[dtype]
    arch = ARCHS[kind]
    want = jfront.batch_specs(jcfgs.get_config(arch), 3, 40, embed_dtype=jdt)
    got = tfront.batch_specs(tcfgs.get_config(arch), 3, 40, embed_dtype=tdt)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape
        assert str(got[k].dtype).split(".")[-1] == str(spec.dtype)
    assert tmodels.batch_specs is tfront.batch_specs
    assert tmodels.frontend_split is tfront.frontend_split


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_random_batch_is_the_references(kind, dtype):
    """Embeds, tokens and labels bit for bit (labels -1 over an image
    prefix), for the full config and the smoke one."""
    jdt, tdt = DTYPES[dtype]
    arch = ARCHS[kind]
    for jc, tc, s in ((jcfgs.get_config(arch), tcfgs.get_config(arch), 24),
                      (jcfgs.smoke_config(arch), tcfgs.smoke_config(arch), 8)):
        want = jfront.random_batch(jc, 2, s, seed=3, embed_dtype=jdt)
        got = tfront.random_batch(tc, 2, s, seed=3, embed_dtype=tdt,
                                  device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
        if "embeds" in got:
            assert got["embeds"].dtype == tdt
        if kind == "vision":
            n_emb = tfront.frontend_split(tc, s)[0]
            assert (got["labels"][:, :n_emb] == -1).all()
            assert (got["labels"][:, n_emb:] >= 0).all()


def test_bf16_cast_rounds_as_jnp_at_f32_ties():
    """An f64 just above an f32 value halfway between two bf16 values:
    ``jnp.asarray(.., bfloat16)`` rounds through f32 (the tie goes to
    even), and so does the port's cast."""
    rng = np.random.default_rng(0)
    bits = (rng.integers(0x3f000000, 0x40000000, 4096).astype(np.uint32)
            & 0xffff0000) | 0x8000
    ties = bits.view(np.float32).astype(np.float64)
    x = np.concatenate([ties * (1 + 2**-40), ties * (1 - 2**-40)])
    want = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)).view(np.int16)
    got = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


def test_serve_step_takes_embeds():
    """The audio serve step decodes on frame embeddings, as the
    reference's positional ``embeds`` argument does."""
    arch = ARCHS["audio"]
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    jparams, tparams = jax.tree.map(jnp.asarray, tree), \
        params_from_jax(tc, tree, "cpu")
    emb = np.random.default_rng(6).normal(size=(2, 6, tc.d_model))
    emb = emb.astype(np.float32)
    jlog, jcache = jmodels.prefill(jc, jparams,
                                   {"embeds": jnp.asarray(emb[:, :4])}, 8)
    tlog, tcache = tmodels.prefill(tc, tparams,
                                   {"embeds": torch.from_numpy(emb[:, :4])}, 8)
    jstep, tstep = jmake_serve_step(jc, Parallel()), tmake_serve_step(tc, tmodels.Parallel())
    jtok = jnp.zeros((2, 1), jnp.int32)
    ttok = torch.zeros((2, 1), dtype=torch.int32)
    for i in (4, 5):
        pos = np.full((2,), i, np.int32)
        jtok, jlog, jcache = jstep(jparams, jcache, jtok, jnp.asarray(pos),
                                   jnp.asarray(emb[:, i:i + 1]))
        ttok, tlog, tcache = tstep(tparams, tcache, ttok,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(emb[:, i:i + 1]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


ARGV = ["--smoke", "--batch", "2", "--prompt-len", "8", "--decode-tokens", "3"]


def _reference_serve_tokens(jc, jparams, audio: bool):
    """The reference serve's step 3 (``repro/launch/serve.py``), returning
    the greedy tokens and the last logits that its ``main`` discards."""
    batch = jmodels.random_batch(jc, 2, 8, seed=0)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = jmodels.prefill(jc, jparams, prompt, max_len=12)
    step = jmake_serve_step(jc, Parallel())
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    pos = jnp.full((2,), 8, jnp.int32)
    emb = jnp.ones((2, 1, jc.d_model), jnp.float32) if audio else None
    toks = [np.asarray(tok)]
    for _ in range(3):
        tok, logits, cache = step(jparams, cache, tok, pos, emb)
        pos = pos + 1
        toks.append(np.asarray(tok))
    return np.concatenate(toks, axis=1), np.asarray(logits)


@pytest.mark.parametrize("kind", list(ARCHS))
def test_serve_smoke_tokens_are_the_references(kind, monkeypatch, capsys):
    """``serve --smoke --arch <arch>`` on the reference's weights: the
    reference's keys (no placement for a dense model), and the reference
    loop's greedy tokens."""
    arch = ARCHS[kind]
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    assert not tc.has_moe
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            tc, tree, device))
    argv = ARGV + ["--arch", arch]
    got, state = tserve.run(argv + ["--device", "cpu", "--space-sim"])
    lines = capsys.readouterr().out
    want = jserve.main(argv + ["--space-sim"])
    assert set(got) == set(want) == {"arch", "tokens_per_s"}
    assert "[serve] 6 tokens in " in lines and "[placement]" not in lines
    tokens, logits = _reference_serve_tokens(
        jc, jax.tree.map(jnp.asarray, tree), kind == "audio")
    np.testing.assert_array_equal(state["tokens"].numpy(), tokens)
    np.testing.assert_allclose(state["logits"].numpy(), logits, atol=2e-4,
                               rtol=2e-4)
