"""The port's serve entry point vs the reference's, on the CPU.

Step 4's ``--traffic`` needs the reference's ``repro.traffic``, imported
through the ``ref`` fixture of ``tests/test_torch_fleet.py`` (the
``enable_x64`` shim)."""
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
from test_torch_fleet import ref  # noqa: F401

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
    jstep, tstep = jmake_serve_step(jc, Parallel()), tmake_serve_step(tc, tmodels.Parallel())
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


def _same_rows(got, want):
    """Table rows (the metrics' ``row()``, rounded to 3 decimals): the
    same keys, strings and flags, numbers to rtol 1e-5 or one unit of the
    last rounded digit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, float) and not isinstance(v, bool):
                assert np.isclose(g[k], v, rtol=1e-5, atol=1.0001e-3,
                                  equal_nan=True), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


@pytest.mark.parametrize("flag", [
    ["--space-sim"], ["--traffic", "smoke"], ["--fail-device", "0"],
    ["--traffic", "smoke", "--admission", "aimd", "--federation", "2"]])
def test_step4_flags_match_reference(ref, flag, monkeypatch, capsys):
    """Steps 4 and 5 (space-network accounting, the traffic scenario, the
    federation, the elastic demo) of the port's serve on the CPU against
    the reference's, both at smoke size.  The port serves the reference's
    weights (converted), so the router counts that every later number
    rests on are the reference's."""
    jc, tc = jcfgs.smoke_config(ARCH), tcfgs.smoke_config(ARCH)
    jparams = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            tc, jparams, device))
    got = tserve.main(ARGV + ["--device", "cpu"] + flag)
    lines = capsys.readouterr().out
    want = jserve.main(ARGV + flag)
    assert set(got) == set(want)
    assert got["dispatch_cost"] == want["dispatch_cost"]
    if "--fail-device" in flag:
        assert got["migration_bytes"] == want["migration_bytes"]
        assert "[elastic] device 0 failed: " in lines
    if "space_latency_s" in want:
        for k, v in want["space_latency_s"].items():
            assert np.isclose(got["space_latency_s"][k], v, rtol=1e-6)
        assert "[space-sim] s/token: SpaceMoE=" in lines
    if "traffic" in want:
        _same_rows(got["traffic"], want["traffic"])
        assert "[traffic] " in lines
    if "federation" in want:
        for k in ("n_rounds", "n_rerouted"):
            assert got["federation"][k] == want["federation"][k]
        _same_rows(got["federation"]["rows"], want["federation"]["rows"])
        assert "[federation] K=2 members, " in lines


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
    """What the model still refuses, it refuses loudly: a mixer or an FFN
    it does not know (``ValueError``, as the reference's ``_block_init``)
    and the placement of an EP-slotted stack (``ValueError`` naming V !=
    E; the reference's fails inside the einsum)."""
    from repro_torch.models.config import LayerSpec
    base = tcfgs.smoke_config("llama-moe-3.5b")
    for spec in (LayerSpec("rwkv", "moe"), LayerSpec("mamba", "glu")):
        cfg = dataclasses.replace(base, pattern=(spec,))
        with pytest.raises(ValueError, match="unknown"):
            tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="unknown"):
            tmodels.init_cache(cfg, 1, 4, "cpu")
    slotted = dataclasses.replace(base, moe_slotting=True)
    params = tmodels.init_params(slotted, torch.Generator().manual_seed(0),
                                 "cpu")
    with pytest.raises(ValueError, match="virtual"):
        tmodels.apply_placement(params["layers"][0]["ffn"],
                                np.arange(slotted.n_experts))


def test_serve_smoke_xlstm_on_the_cpu(capsys):
    """``serve --smoke --arch xlstm-350m``: no MoE, so steps 1-2 and 4 are
    skipped as in the reference (no placement line, no space latency even
    with ``--space-sim``); the recurrent state carries through prefill and
    decode to finite logits and in-range greedy tokens."""
    argv = ["--smoke", "--arch", "xlstm-350m", "--batch", "2",
            "--prompt-len", "8", "--decode-tokens", "3", "--space-sim",
            "--device", "cpu"]
    out, state = tserve.run(argv)
    lines = capsys.readouterr().out
    assert set(out) == {"arch", "tokens_per_s"}
    assert out["arch"] == "xlstm-350m-smoke"
    assert "[placement]" not in lines and "[space-sim]" not in lines
    cfg = tcfgs.smoke_config("xlstm-350m")
    assert bool(torch.isfinite(state["logits"]).all())
    assert tuple(state["tokens"].shape) == (2, 4)
    assert 0 <= int(state["tokens"].min()) < cfg.padded_vocab
    assert int(state["tokens"].max()) < cfg.padded_vocab
