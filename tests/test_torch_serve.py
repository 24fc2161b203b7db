"""The port's serve driver (steps 1-3) vs the reference's, on the CPU."""
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
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import Parallel
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_serve_step as tmake_serve_step

ARCH = "llama-moe-3.5b"
ARGV = ["--smoke", "--batch", "2", "--prompt-len", "8", "--decode-tokens", "3"]


def test_serve_main_matches_reference_keys(capsys):
    got = tserve.main(ARGV + ["--device", "cpu"])
    lines = capsys.readouterr().out
    want = jserve.main(ARGV)
    assert set(got) == set(want)
    assert got["arch"] == want["arch"]
    assert set(got["dispatch_cost"]) == set(want["dispatch_cost"])
    assert np.isfinite(got["tokens_per_s"]) and got["tokens_per_s"] > 0
    assert all(np.isfinite(v) for v in got["dispatch_cost"].values())
    assert "[placement] expected dispatch cost: theorem1=" in lines
    assert "[serve] 6 tokens in " in lines


def test_serve_steps_match_reference():
    """Calibrate -> Theorem-1 placement -> prefill -> greedy decode with the
    same weights: equal router counts, identical expert permutations and
    dispatch costs, equal greedy tokens."""
    jc, tc = jcfgs.smoke_config(ARCH), tcfgs.smoke_config(ARCH)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jparams), "cpu")

    jcounts = jserve.calibrate_router_stats(jc, jparams,
                                            jmodels.random_batch(jc, 4, 8, seed=7))
    tcounts = tserve.calibrate_router_stats(
        tc, tparams, tmodels.random_batch(tc, 4, 8, seed=7, device="cpu"))
    np.testing.assert_array_equal(tcounts, jcounts)

    jparams, jplans, jcosts = jserve.plan_and_apply_placement(jc, jparams, jcounts)
    tparams, tplans, tcosts = tserve.plan_and_apply_placement(tc, tparams, tcounts)
    assert tcosts == jcosts
    for jp, tp in zip(jplans, tplans, strict=True):
        np.testing.assert_array_equal(tp.expert_perm, jp.expert_perm)
    for u, layer in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(
            layer["ffn"]["w_up"].numpy(),
            np.asarray(jparams["units"]["b0"]["ffn"]["w_up"][u]))

    prompt = jmodels.random_batch(jc, 2, 8, seed=0)
    jlog, jcache = jmodels.prefill(jc, jparams, {"tokens": prompt["tokens"]},
                                   max_len=12)
    tlog, tcache = tmodels.prefill(tc, tparams,
                                   {"tokens": torch.from_numpy(np.array(prompt["tokens"]))},
                                   max_len=12)
    jstep, tstep = jmake_serve_step(jc, Parallel()), tmake_serve_step(tc)
    jtok = jnp.argmax(jlog, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    for i in range(3):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = np.full((2,), 8 + i, np.int32)
        jtok, jlog, jcache = jstep(jparams, jcache, jtok, jnp.asarray(pos), None)
        ttok, tlog, tcache = tstep(tparams, tcache, ttok, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4,
                                   rtol=2e-4)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("flag", [["--space-sim"], ["--traffic", "smoke"],
                                  ["--fail-device", "0"]])
def test_unported_flags_exit_with_an_error(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(ARGV + ["--device", "cpu"] + flag)
    assert exc.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(ARGV)
    cfg = tcfgs.smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.random_batch(cfg, 1, 4)


def test_unported_model_features_raise():
    cfg = dataclasses.replace(tcfgs.smoke_config(ARCH), n_shared_experts=1)
    with pytest.raises(NotImplementedError, match="shared experts"):
        tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(KeyError, match="not yet ported"):
        tcfgs.get_config("deepseek-moe-16b")
