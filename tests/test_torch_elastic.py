"""The port's elastic re-placement (``repro_torch.distributed``) and
token-generation simulator (``repro_torch.core.simulator``) against the
reference's, on the CPU.

Both are host numpy over the same inputs, so ``replan_on_failure``,
``replan_with_stragglers``, ``migration`` and
``simulate_token_generation_legacy`` are held bit for bit;
``simulate_token_generation`` runs the engine, held as
``tests/test_torch_engine.py`` holds ``evaluate_plans`` (rtol 1e-6,
identical drops).  The cases are those of the reference's
``tests/test_substrate.py`` (elastic) and ``tests/test_schedule.py`` (the
two-slot switch against a device-ring migration).
"""
import numpy as np
import pytest

import repro.core as rc
import repro.distributed as rd
import repro_torch.core as pc
import repro_torch.distributed as pd


def _plan_equal(a, b):
    np.testing.assert_array_equal(a.expert_perm, b.expert_perm)
    np.testing.assert_array_equal(a.device_cost_s, b.device_cost_s)
    assert a.experts_per_device == b.experts_per_device
    assert a.origin == b.origin


def _migration_equal(a, b):
    np.testing.assert_array_equal(a.moved_experts, b.moved_experts)
    np.testing.assert_array_equal(a.old_devices, b.old_devices)
    np.testing.assert_array_equal(a.new_devices, b.new_devices)
    assert a.bytes_moved == b.bytes_moved


def test_distributed_names_match_reference():
    """Every name of ``repro.distributed``: the elastic ones and
    ``ShardingRules``."""
    assert set(pd.__all__) == set(rd.__all__)
    for n in pd.__all__:
        sub = "sharding" if n == "ShardingRules" else "elastic"
        assert getattr(pd, n).__module__ == f"repro_torch.distributed.{sub}"


@pytest.mark.parametrize("shape,failed,origin", [
    ((4, 4), {3, 7}, 0),
    ((4, 4), {0, 5, 6}, 0),          # the origin fails: survivors[0] leads
    ((16,), {2}, 5),
    ((2, 4, 2), {1, 2, 3, 4, 5}, 11),
])
def test_replan_on_failure_matches_reference(shape, failed, origin):
    rng = np.random.default_rng(len(failed))
    w = rng.gamma(2, 1, 16) + 0.1
    rt, pt = rc.TorusSpec(shape=shape), pc.TorusSpec(shape=shape)
    a, sa = rd.replan_on_failure(w, 2, rt, failed, origin=origin)
    b, sb = pd.replan_on_failure(w, 2, pt, failed, origin=origin)
    _plan_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    # The reference test's invariants, on the port's plan.
    occupied = b.expert_perm[b.expert_perm >= 0]
    assert sorted(occupied.tolist()) == list(range(16))
    assert not set(sb.tolist()) & failed
    base = pc.plan_expert_devices(w, 2, pt)
    ma = rd.migration(rc.plan_expert_devices(w, 2, rt), a, 1e6, sa)
    mb = pd.migration(base, b, 1e6, sb)
    _migration_equal(ma, mb)
    assert 0 < len(mb.moved_experts) <= 16
    assert not set(mb.new_devices.tolist()) & failed


def test_replan_on_failure_refuses_losing_every_device():
    torus = pc.TorusSpec(shape=(2, 2))
    with pytest.raises(ValueError, match="no surviving devices"):
        pd.replan_on_failure(np.ones(4), 1, torus, {0, 1, 2, 3})


@pytest.mark.parametrize("slowdown", [{"hot": 100.0}, {"hot": 3.0, 5: 1.5}])
def test_replan_with_stragglers_matches_reference(slowdown):
    rng = np.random.default_rng(1)
    w = np.sort(rng.gamma(2, 1, 16))[::-1] + 0.1    # expert 0 hottest
    rt, pt = rc.TorusSpec(shape=(4, 4)), pc.TorusSpec(shape=(4, 4))
    hot_dev = pc.plan_expert_devices(w, 2, pt).device_of_expert(0)
    slow = {(hot_dev if k == "hot" else k): v for k, v in slowdown.items()}
    a = rd.replan_with_stragglers(w, 2, rt, slow)
    b = pd.replan_with_stragglers(w, 2, pt, slow)
    _plan_equal(a, b)
    if slow[hot_dev] >= 100.0:
        assert b.device_of_expert(0) != hot_dev


def test_migration_two_slot_switch_matches_reference():
    """The reference's hand-checked switch: experts 0 and 1 swap devices
    on the ring; the port's Migration and the schedule-level edge agree."""
    kw = dict(device_cost_s=np.zeros(4), experts_per_device=1, origin=0)
    out = []
    for core, dist in ((rc, rd), (pc, pd)):
        identity = core.DevicePlacementPlan(expert_perm=np.arange(4), **kw)
        swapped = core.DevicePlacementPlan(
            expert_perm=np.array([1, 0, 2, 3]), **kw)
        out.append(dist.migration(identity, swapped, 3.5e6))
    _migration_equal(*out)
    assert set(out[1].moved_experts) == {0, 1}
    assert out[1].bytes_moved == 2 * 3.5e6
    sats = np.array([10, 20, 30, 40])
    old = pc.PlacementPlan(gateways=np.array([5]),
                           expert_sats=sats[None, :], name="old")
    new = pc.PlacementPlan(gateways=np.array([5]),
                           expert_sats=sats[np.array([1, 0, 2, 3])][None, :],
                           name="new")
    edge = pc.migration_between(old, new, 3.5e6)
    assert set(edge.experts) == set(out[1].moved_experts)
    assert edge.bytes_moved == out[1].bytes_moved


# --------------------------------------------------------------------- #
# core.simulator
# --------------------------------------------------------------------- #


def _sim_world(core, multi):
    con = core.Constellation(core.ConstellationConfig.scaled(8, 12,
                                                             n_slots=10))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plan = (core.multi_expert_plan(con, topo, act, 2, mode="spread")
            if multi else core.spacemoe_plan(con, topo, act))
    return topo, act, plan


@pytest.mark.parametrize("multi,staleness", [(False, 0), (True, 0),
                                             (False, 2)])
def test_simulate_token_generation_matches_reference(multi, staleness):
    kw = dict(n_tokens=300, route_staleness=staleness,
              reroute_penalty_s=0.05)
    wl, comp = rc.MoEWorkload.llama_moe_3p5b(), rc.ComputeConfig()
    pwl, pcomp = pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig()
    topo, act, plan = _sim_world(rc, multi)
    ptopo, pact, pplan = _sim_world(pc, multi)
    legacy = rc.simulate_token_generation_legacy(
        plan, topo, act, wl, comp, np.random.default_rng(2), **kw)
    plegacy = pc.simulate_token_generation_legacy(
        pplan, ptopo, pact, pwl, pcomp, np.random.default_rng(2), **kw)
    np.testing.assert_array_equal(plegacy.token_latency_s,
                                  legacy.token_latency_s)
    np.testing.assert_array_equal(plegacy.layer_latency_s,
                                  legacy.layer_latency_s)
    assert plegacy.plan_name == legacy.plan_name
    numpy_path = pc.simulate_token_generation(
        pplan, ptopo, pact, pwl, pcomp, np.random.default_rng(2),
        backend="numpy", **kw)
    np.testing.assert_array_equal(numpy_path.token_latency_s,
                                  plegacy.token_latency_s)
    eng = rc.simulate_token_generation(plan, topo, act, wl, comp,
                                       np.random.default_rng(2), **kw)
    peng = pc.simulate_token_generation(pplan, ptopo, pact, pwl, pcomp,
                                        np.random.default_rng(2),
                                        device="cpu", **kw)
    np.testing.assert_array_equal(peng.delivered, eng.delivered)
    np.testing.assert_allclose(peng.token_latency_s, eng.token_latency_s,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="backend"):
        pc.simulate_token_generation(pplan, ptopo, pact, pwl, pcomp,
                                     np.random.default_rng(2),
                                     backend="jax")
