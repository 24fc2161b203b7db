"""jamba-1.5-large-398b at smoke size through serve steps 1-4, the port
against the reference, on the CPU.

The first architecture with more than one MoE block a pattern unit (four
of eight, under Mamba and attention mixers): step 1's (units, E) router
counts sum the unit's four blocks, step 2 permutes every MoE block of
unit u by unit u's plan, and the placement costs and step 4's space
latency are the reference's.  Both packages run on the reference's
weights (``params_from_jax``), drawn once for the module.
"""
import jax
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

ARCH = "jamba-1.5-large-398b"
STACKS = ("router", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def jamba():
    """(reference config, port config, the reference's weights as numpy)."""
    jc, tc = jcfgs.smoke_config(ARCH), tcfgs.smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jmodels.init_params(
        jc, jax.random.PRNGKey(0)))
    return jc, tc, tree


def test_serve_smoke_jamba_is_the_references(jamba, monkeypatch, capsys):
    """``serve --smoke --arch jamba-1.5-large-398b --space-sim`` on the
    reference's weights: the same keys, the dispatch costs bit for bit
    (the reference's ring of min(16, 8) = 8 devices) and step 4's space
    latency on the reference's 12 x 16 world."""
    jc, tc, tree = jamba
    monkeypatch.setattr(tserve, "init_params",
                        lambda cfg, gen, device: params_from_jax(
                            tc, tree, device))
    argv = ["--smoke", "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
            "--decode-tokens", "2", "--space-sim"]
    got = tserve.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out
    want = jserve.main(argv)
    assert set(got) == set(want)
    assert got["dispatch_cost"] == want["dispatch_cost"]
    for k, v in want["space_latency_s"].items():
        assert np.isclose(got["space_latency_s"][k], v, rtol=1e-6)
    assert tserve.ep_ring_devices(tc.n_experts) == 8
    assert tserve.plane_sats(tc.n_units, tc.n_experts, 12) == 16
    assert "[placement] expected dispatch cost: theorem1=" in lines
    assert "[space-sim] s/token: SpaceMoE=" in lines


def test_placement_permutes_every_moe_block_of_a_unit(jamba):
    """Step 1: the (units, E) counts equal the reference's and sum the
    unit's four MoE blocks (each block's selection shares sum to 1, so a
    unit's row sums to 4).  Step 2: each of unit u's four MoE stacks and
    router columns are permuted by unit u's plan exactly as the reference
    permutes them; the dense FFNs and the mixers are left as they were."""
    jc, tc, tree = jamba
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    tparams = params_from_jax(tc, tree, "cpu")
    before = params_from_jax(tc, tree, "cpu")
    jb = jmodels.random_batch(jc, 4, 8, seed=7)
    tb = tmodels.random_batch(tc, 4, 8, seed=7, device="cpu")
    jcounts = jserve.calibrate_router_stats(jc, jparams, jb)
    tcounts = tserve.calibrate_router_stats(tc, tparams, tb)
    np.testing.assert_array_equal(tcounts, jcounts)
    moe_blocks = [i for i, spec in enumerate(tc.pattern) if spec.ffn == "moe"]
    assert tcounts.shape == (tc.n_units, tc.n_experts) and len(moe_blocks) == 4
    np.testing.assert_allclose(tcounts.sum(axis=1), len(moe_blocks),
                               rtol=1e-6)

    jplaced, jplans, jcosts = jserve.plan_and_apply_placement(jc, jparams,
                                                              jcounts)
    _, tplans, tcosts = tserve.plan_and_apply_placement(tc, tparams, tcounts)
    assert tcosts == jcosts
    width = len(tc.pattern)
    for u, (jp, tp) in enumerate(zip(jplans, tplans, strict=True)):
        np.testing.assert_array_equal(tp.expert_perm, jp.expert_perm)
        perm = torch.as_tensor(tp.expert_perm)
        for b in range(width):
            layer, was = tparams["layers"][u * width + b], \
                before["layers"][u * width + b]
            if b not in moe_blocks:
                for k, v in layer["ffn"].items():
                    assert torch.equal(v, was["ffn"][k])
                continue
            for k in STACKS:
                want = np.asarray(jplaced["units"][f"b{b}"]["ffn"][k][u])
                np.testing.assert_array_equal(layer["ffn"][k].numpy(), want)
                moved = was["ffn"][k][:, perm] if k == "router" \
                    else was["ffn"][k][perm]
                assert torch.equal(layer["ffn"][k], moved)
            for k, v in layer["mixer"].items():
                assert torch.equal(v, was["mixer"][k])


def test_step4_at_full_size_widens_the_world():
    """At full size step 4 sees 9 MoE units of 16 experts: the reference's
    12 x 16 world gives each unit's ring subnet 12 x (16 // 9) = 12
    satellites, fewer than the 16 experts and the gateway, so its serve
    raises there; the port's ``plane_sats`` gives 12 x 18 (24 a subnet)
    and step 4 runs on router counts of the full model's shape."""
    cfg = tcfgs.get_config(ARCH)
    units, e = cfg.n_units, cfg.n_experts
    assert (units, e) == (9, 16)
    assert 12 * (16 // units) < e + 1
    sats = tserve.plane_sats(units, e, 12)
    assert sats == 18 and 12 * (sats // units) >= e + 1
    assert tserve.ep_ring_devices(e) == 16
    counts = np.random.default_rng(0).dirichlet(np.ones(e), units) * 4
    args = tserve._parser().parse_args(["--arch", ARCH, "--space-sim"])
    out = {}
    tserve._space_sim(cfg, counts.astype(np.float32), args,
                      torch.device("cpu"), out)
    lat = out["space_latency_s"]
    assert set(lat) == {"SpaceMoE", "RandIntra-CG"}
    assert all(np.isfinite(v) and v > 0 for v in lat.values())
