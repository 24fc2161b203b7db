"""The port's plan-evaluation engine against the reference's, on the CPU.

Both engines get the same numpy world (topology, plans, activation) and
the same numpy random stream, or pinned ``slots=``/``draws=``.  The pass
runs in float32 in both; the tolerance is rtol 1e-6 because XLA and
PyTorch are free to order a float32 reduction differently (the port sums
layers in index order, which is XLA's CPU order, and in practice the
results agree bit for bit).  Drops (NaN tokens) must be identical.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro.core import (ActivationModel, ComputeConfig, Constellation,
                        ConstellationConfig, LinkConfig, MoEWorkload,
                        PlanSchedule, ServiceModel, evaluate_plans,
                        evaluate_schedules, load_table, multi_expert_plan,
                        rand_intra_cg_plan, rand_place_plan, rank_plans,
                        sample_topology, schedule_ingress_offsets,
                        spacemoe_plan, subnet_routing_sets)
from repro.core.engine import ScheduleBatch

RTOL = 1e-6          # float32 pass; reduction order may differ


def _worlds(n_experts=4, n_layers=4):
    cfg = dict(n_slots=10)
    con = Constellation(ConstellationConfig.scaled(8, 12, **cfg))
    topo = sample_topology(con, LinkConfig(), np.random.default_rng(0))
    act = ActivationModel.zipf(n_layers, n_experts, 2, seed=1)
    pcon = pc.Constellation(pc.ConstellationConfig.scaled(8, 12, **cfg))
    ptopo = pc.sample_topology(pcon, pc.LinkConfig(),
                               np.random.default_rng(0))
    pact = pc.ActivationModel.zipf(n_layers, n_experts, 2, seed=1)
    return (con, topo, act), (pcon, ptopo, pact)


def _plans(con, topo, act, mod):
    rng = np.random.default_rng(3)
    return [mod.spacemoe_plan(con, topo, act),
            mod.rand_place_plan(con.cfg, act.n_layers, act.n_experts, rng),
            mod.rand_intra_cg_plan(con.cfg, act.n_layers, act.n_experts, rng),
            mod.multi_expert_plan(con, topo, act, 2, mode="spread")]


class _Ref:
    spacemoe_plan = staticmethod(spacemoe_plan)
    rand_place_plan = staticmethod(rand_place_plan)
    rand_intra_cg_plan = staticmethod(rand_intra_cg_plan)
    multi_expert_plan = staticmethod(multi_expert_plan)


def _close(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for a, b in zip(ref_results, port_results):
        assert a.plan_name == b.plan_name
        np.testing.assert_array_equal(a.delivered, b.delivered)
        np.testing.assert_allclose(b.token_latency_s, a.token_latency_s,
                                   rtol=RTOL)
        np.testing.assert_allclose(b.layer_latency_s, a.layer_latency_s,
                                   rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(route_staleness=2, reroute_penalty_s=0.03),
    dict(include_lm_head=False, eta=0.7),
    dict(ctx_len=256),
], ids=["analytic", "stale", "eta-no-head", "ctx256"])
def test_evaluate_plans_matches_reference(kw):
    (con, topo, act), (pcon, ptopo, pact) = _worlds()
    plans, pplans = _plans(con, topo, act, _Ref), _plans(pcon, ptopo, pact, pc)
    # Sever every ISL of the hottest layer-0 expert's satellite in half
    # the slots: tokens routed there then are undeliverable (NaN).
    victim = int(plans[0].expert_sats[0][np.argmax(act.probs(0))])
    for t in (topo, ptopo):
        t.edge_mask[: t.n_slots // 2, (t.edges == victim).any(axis=1)] = False
    wl, comp = MoEWorkload.llama_moe_3p5b(), ComputeConfig()
    ref = evaluate_plans(plans, topo, act, wl, comp,
                         np.random.default_rng(5), n_tokens=400, **kw)
    port = pc.evaluate_plans(pplans, ptopo, pact,
                             pc.MoEWorkload.llama_moe_3p5b(),
                             pc.ComputeConfig(), np.random.default_rng(5),
                             n_tokens=400, device="cpu", **kw)
    assert not port[0].delivered.all()                  # drops exercised
    _close(ref, port)


def test_evaluate_plans_node_sets_matches_reference():
    (con, topo, act), (pcon, ptopo, pact) = _worlds()
    ref = evaluate_plans(
        _plans(con, topo, act, _Ref)[:2], topo, act,
        MoEWorkload.llama_moe_3p5b(), ComputeConfig(),
        np.random.default_rng(2), n_tokens=300,
        node_sets=subnet_routing_sets(con.cfg, 4))
    port = pc.evaluate_plans(
        _plans(pcon, ptopo, pact, pc)[:2], ptopo, pact,
        pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig(),
        np.random.default_rng(2), n_tokens=300,
        node_sets=pc.subnet_routing_sets(pcon.cfg, 4), device="cpu")
    _close(ref, port)


def test_evaluate_plans_calibrated_matches_reference():
    (con, topo, act), (pcon, ptopo, pact) = _worlds(n_experts=8)
    speed = np.random.default_rng(4).uniform(0.5, 1.5, topo.n_sats)
    wl, pwl = MoEWorkload.llama_moe_3p5b(), pc.MoEWorkload.llama_moe_3p5b()
    svc = ServiceModel.calibrated(wl, ComputeConfig(),
                                  load_table("llama-moe-3.5b"),
                                  sat_speed=speed)
    psvc = pc.ServiceModel.calibrated(pwl, pc.ComputeConfig(),
                                      pc.load_table("llama-moe-3.5b"),
                                      sat_speed=speed)
    ref = evaluate_plans(_plans(con, topo, act, _Ref), topo, act, wl,
                         ComputeConfig(), np.random.default_rng(5),
                         n_tokens=300, service_model=svc)
    port = pc.evaluate_plans(_plans(pcon, ptopo, pact, pc), ptopo, pact,
                             pwl, pc.ComputeConfig(),
                             np.random.default_rng(5), n_tokens=300,
                             service_model=psvc, device="cpu")
    _close(ref, port)


def test_evaluate_schedules_with_switch_matches_reference():
    (con, topo, act), (pcon, ptopo, pact) = _worlds()
    plans, pplans = _plans(con, topo, act, _Ref), _plans(pcon, ptopo, pact, pc)
    slot_plan = np.array([0, 1, 1, 2, 0, 3, 3, 1, 0, 2])
    sched = [PlanSchedule(plans=plans, slot_plan=slot_plan, name="mix"),
             plans[1]]
    psched = [pc.PlanSchedule(plans=pplans, slot_plan=slot_plan, name="mix"),
              pplans[1]]
    rng = np.random.default_rng(9)
    slots = rng.integers(0, 10, 500)
    draws = np.stack([act.sample(layer, rng, 500) for layer in range(4)])
    wl, comp = MoEWorkload.llama_moe_3p5b(), ComputeConfig()
    ref = evaluate_schedules(sched, topo, act, wl, comp, None, n_tokens=500,
                             slots=slots, draws=draws)
    port = pc.evaluate_schedules(psched, ptopo, pact,
                                 pc.MoEWorkload.llama_moe_3p5b(),
                                 pc.ComputeConfig(), None, n_tokens=500,
                                 slots=slots, draws=draws, device="cpu")
    _close(ref, port)
    batch = ScheduleBatch.from_schedules(
        [PlanSchedule.constant(p, 10) if not isinstance(p, PlanSchedule)
         else p for p in sched], topo)
    pbatch = pc.ScheduleBatch.from_schedules(
        [pc.PlanSchedule.constant(p, 10)
         if not isinstance(p, pc.PlanSchedule) else p for p in psched],
        ptopo)
    np.testing.assert_array_equal(pbatch.plan_row, batch.plan_row)
    ing = np.random.default_rng(1).integers(0, topo.n_sats, 500)
    np.testing.assert_array_equal(
        pc.schedule_ingress_offsets(pbatch, slots, ing),
        schedule_ingress_offsets(batch, slots, ing))


def test_rank_plans_matches_reference():
    (con, topo, act), (pcon, ptopo, pact) = _worlds()
    ref = rank_plans(_plans(con, topo, act, _Ref), topo, act,
                     MoEWorkload.llama_moe_3p5b(), ComputeConfig(),
                     np.random.default_rng(6), n_tokens=300)
    port = pc.rank_plans(_plans(pcon, ptopo, pact, pc), ptopo, pact,
                         pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig(),
                         np.random.default_rng(6), n_tokens=300,
                         device="cpu")
    assert [p.name for p, _ in port] == [p.name for p, _ in ref]
    _close([r for _, r in ref], [r for _, r in port])


def test_torch_sample_backend_draws_conditional_poisson():
    """Draws from an explicit torch.Generator: K distinct experts per
    token, marginals at Eq. 14, engine means near the host stream's."""
    (_, _, _), (pcon, ptopo, pact) = _worlds()
    gen = torch.Generator().manual_seed(0)
    draws = pc.engine.sample_draws_torch(pact, 20000, gen,
                                         torch.device("cpu")).numpy()
    assert draws.shape == (4, 20000, 2)
    assert (np.diff(np.sort(draws, axis=2), axis=2) != 0).all()
    for layer in range(4):
        freq = np.bincount(draws[layer].ravel(), minlength=4) / 20000
        np.testing.assert_allclose(freq, pact.probs(layer), atol=0.02)
    plan = pc.spacemoe_plan(pcon, ptopo, pact)
    args = ([plan], ptopo, pact, pc.MoEWorkload.llama_moe_3p5b(),
            pc.ComputeConfig(), np.random.default_rng(5))
    host = pc.evaluate_plans(*args, n_tokens=2000, device="cpu")[0]
    dev = pc.evaluate_plans(*args, n_tokens=2000, device="cpu",
                            sample_backend="torch",
                            generator=torch.Generator().manual_seed(1))[0]
    assert abs(dev.mean_s - host.mean_s) / host.mean_s < 0.05
    with pytest.raises(ValueError):
        pc.evaluate_plans(*args, device="cpu", sample_backend="jax")


def test_engine_refuses_a_mismatched_batch():
    (_, _, _), (pcon, ptopo, pact) = _worlds()
    plans = _plans(pcon, ptopo, pact, pc)
    batch = pc.PlanBatch.from_plans(plans[:2], ptopo)
    with pytest.raises(ValueError):
        pc.evaluate_plans(plans[:2][::-1], ptopo, pact,
                          pc.MoEWorkload.llama_moe_3p5b(),
                          pc.ComputeConfig(), np.random.default_rng(0),
                          batch=batch, device="cpu")


def test_ingress_offsets_and_layer_stats_are_bitwise():
    """``ingress_offsets`` (host numpy over the deduped distance table,
    unreachable ingress satellites at +inf) and ``SimResult.layer_stats``
    (NaN-aware per-layer mean and std) equal the reference's bit for bit
    on the same batch and results."""
    from repro.core import ingress_offsets
    from repro.core.engine import PlanBatch
    (con, topo, act), (pcon, ptopo, pact) = _worlds()
    plans = _plans(con, topo, act, _Ref)
    batch = PlanBatch.from_plans(plans, topo)
    pbatch = pc.PlanBatch.from_plans(_plans(pcon, ptopo, pact, pc), ptopo)
    rng = np.random.default_rng(8)
    slots = rng.integers(0, topo.n_slots, 700)
    ing = rng.integers(0, topo.n_sats, 700)
    want = ingress_offsets(batch, slots, ing)
    got = pc.ingress_offsets(pbatch, slots, ing)
    assert got.shape == (len(plans), 700) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref = evaluate_plans(plans, topo, act, MoEWorkload.llama_moe_3p5b(),
                         ComputeConfig(), np.random.default_rng(4),
                         n_tokens=300, route_staleness=2)
    port = pc.evaluate_plans(_plans(pcon, ptopo, pact, pc), ptopo, pact,
                             pc.MoEWorkload.llama_moe_3p5b(),
                             pc.ComputeConfig(), np.random.default_rng(4),
                             n_tokens=300, route_staleness=2, device="cpu")
    for a, b in zip(ref, port):
        b.layer_latency_s[::7, 1] = np.nan      # undeliverable in that layer
        a.layer_latency_s[::7, 1] = np.nan
        for g, w in zip(b.layer_stats(), a.layer_stats()):
            assert g.shape == (4,)
            np.testing.assert_array_equal(g, w)
