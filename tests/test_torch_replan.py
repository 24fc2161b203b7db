"""The port's re-placement controller and joint control plane against the
reference's, on the CPU.

Both packages get the same seeded numpy inputs: the reference's own
control-plane worlds (``tests/test_control_plane.py``: 8 x 12 satellites,
10 slots, 4 MoE layers of 4 experts, top-2), a quiet two-plan one and a
congested three-plan one that forces plan switches.  The reference's
``repro.traffic`` is imported through the ``ref`` fixture of
``tests/test_torch_fleet.py`` (the ``enable_x64`` shim).  On the CPU the
port's kernels run their plain versions.

What is held bit for bit: the host helpers (``np_sum`` against
``np.sum``, ``masked_quantile`` against ``np.quantile``,
``backlog_penalty_s``, ``replan_base_scores``, ``build_replan_schedule``),
and for ``replan_traffic``, ``replan_traffic_fused``, ``run(replan=)`` and
``run_many(replan=, ...)`` the decisions (slot plans, chosen, switched,
scores, migration bytes) and the results (served and shed sets, TTFT,
E2E and per-token latencies, billed migration bytes), under AIMD and PID
admission too (the reference's PID admit trace differs from the port's
by up to ~1.4e-6 relative, ``tests/test_torch_admission.py``; on these
worlds no decision and no shed request turns on it).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as pc
import repro_torch.traffic as pt
from repro_torch.kernels import admission_ctrl as ctrl_mod
from repro_torch.kernels import admission_window as window_mod
from repro_torch.obs import (DecisionTrace, build_flight_log,
                             joint_decision_events, replan_events)
from repro_torch.traffic import queueing as pq
from test_torch_fleet import _pair, ref  # noqa: F401

SWITCH_GATES = dict(mode="backlog", hysteresis=0.0,
                    migration_weight_s_per_mb=0.0)


def _world(c, t, kind, admission=None):
    """``kind`` "quiet" (2 plans, 3 rps) or "switch" (3 plans, 40 rps) in
    the package of core ``c`` and traffic ``t``, as the reference's
    control-plane tests build them."""
    cfg = c.ConstellationConfig.scaled(8, 12, n_slots=10, survival_prob=1.0)
    con = c.Constellation(cfg)
    topo = c.sample_topology(con, c.LinkConfig(), np.random.default_rng(0))
    act = c.ActivationModel.zipf(4, 4, 2, seed=1)
    acfg = None if admission is None else t.AdmissionConfig(**admission)
    if kind == "quiet":
        plans = [c.spacemoe_plan(con, topo, act),
                 c.rand_intra_cg_plan(con.cfg, 4, 4,
                                      np.random.default_rng(7))]
        req = t.sample_requests(np.random.default_rng(2), rate_rps=3.0,
                                horizon_s=60.0, n_stations=1,
                                prompt_median=4, prompt_max=16,
                                decode_mean=4, decode_max=8)
        qcfg = t.QueueConfig(dt_s=0.05, tail_s=30.0, slot_period_s=20.0,
                             buffer_s=3.0 if acfg is None else 6.0,
                             admission=acfg)
    else:
        plans = [c.rand_intra_cg_plan(con.cfg, 4, 4,
                                      np.random.default_rng(7)),
                 c.spacemoe_plan(con, topo, act),
                 c.rand_intra_cg_plan(con.cfg, 4, 4,
                                      np.random.default_rng(11))]
        req = t.sample_requests(np.random.default_rng(2), rate_rps=40.0,
                                horizon_s=60.0, n_stations=2,
                                prompt_median=8, prompt_max=32,
                                decode_mean=8, decode_max=16)
        qcfg = t.QueueConfig(dt_s=0.05, tail_s=30.0, slot_period_s=10.0,
                             buffer_s=3.0 if acfg is None else 6.0,
                             admission=acfg)
    return topo, act, plans, req, qcfg


def _both(ref, kind, admission=None):
    """{"ref": (topo, act, plans, req, qcfg, core, traffic), "port": ...}."""
    import repro.core as rc
    traffic, _ = ref
    out = {}
    for name, c, t in (("ref", rc, traffic), ("port", pc, pt)):
        out[name] = _world(c, t, kind, admission) + (c, t)
    return out


def _sim(world, seed=4, **kw):
    topo, act, plans, req, qcfg, c, t = world
    if t is pt:
        kw = dict(kw, device="cpu")
    return t.FleetSim(plans, topo, act, c.MoEWorkload.llama_moe_3p5b(),
                      c.ComputeConfig(), req, np.random.default_rng(seed),
                      qcfg, **kw)


@pytest.fixture(scope="module")
def switch_loops(ref):
    """The ungated switching world's (host loop, fused) outcomes, ref and
    port (two tests read them)."""
    w = _both(ref, "switch")
    return w, _loops(w["ref"], SWITCH_GATES), _loops(w["port"], SWITCH_GATES)


def _loops(world, rcfg_kw, seed=4):
    """(host loop, fused) outcomes of one package's world."""
    topo, act, plans, req, qcfg, c, t = world
    kw = {"device": "cpu"} if t is pt else {}
    args = (plans, topo, act, c.MoEWorkload.llama_moe_3p5b(),
            c.ComputeConfig(), req)
    rcfg = t.ReplanConfig(**rcfg_kw)
    host = t.replan_traffic(*args, np.random.default_rng(seed), rcfg, qcfg,
                            **kw)
    fused = t.replan_traffic_fused(*args, np.random.default_rng(seed), rcfg,
                                   qcfg, **kw)
    return host, fused


def _assert_same_report(a, b):
    """Identical decision trajectory: boundaries, incumbents, scores."""
    assert np.array_equal(a.schedule.slot_plan, b.schedule.slot_plan)
    assert a.schedule.name == b.schedule.name
    assert len(a.decisions) == len(b.decisions)
    for da, db in zip(a.decisions, b.decisions):
        assert (da.boundary, da.slot, da.chosen, da.switched) \
            == (db.boundary, db.slot, db.chosen, db.switched), (da, db)
        np.testing.assert_array_equal(da.scores, db.scores, err_msg=str(da))
        assert da.migration_bytes == db.migration_bytes


def _assert_same_result(a, b):
    """Bitwise: served/shed sets, latency traces, billed bytes."""
    assert [p.plan_name for p in a.plans] == [p.plan_name for p in b.plans]
    for pa, pb in zip(a.plans, b.plans):
        np.testing.assert_array_equal(pa.served, pb.served,
                                      err_msg=pa.plan_name)
        if pa.shed is not None or pb.shed is not None:
            np.testing.assert_array_equal(pa.shed, pb.shed,
                                          err_msg=pa.plan_name)
            np.testing.assert_array_equal(pa.retries, pb.retries,
                                          err_msg=pa.plan_name)
        for name in ("ttft_s", "e2e_s", "token_total_s"):
            np.testing.assert_array_equal(getattr(pa, name),
                                          getattr(pb, name),
                                          err_msg=f"{pa.plan_name} {name}")
        assert pa.migration_bytes == pb.migration_bytes


def _assert_same_outcome(a, b):
    _assert_same_report(a.report, b.report)
    _assert_same_result(a.result, b.result)
    assert (a.probe is None) == (b.probe is None)
    if a.probe is not None:
        _assert_same_result(a.probe, b.probe)


# --------------------------------------------------------------------- #
# Host helpers: numpy's summation and quantile, bit for bit
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 7, 8, 9, 32, 128, 129, 300])
def test_np_sum_matches_numpy_pairwise(n):
    rng = np.random.default_rng(n)
    x = (rng.random((64, n)) * 10.0 ** rng.uniform(-4, 4, (64, n))) \
        .astype(np.float32)
    got = pq.np_sum(torch.from_numpy(x)).numpy()
    want = np.array([np.sum(row) for row in x])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    if n >= 8:
        # The index-order sum is another number on some rows: the order
        # matters, so the pin above is not vacuous.
        seq = pq._seq_sum(torch.from_numpy(x)).numpy()
        assert (seq != want).any()


@pytest.mark.parametrize("q,t_kind", [(0.12, "below"), (0.25, "at"),
                                      (0.99, "above"), (0.0, "at 0"),
                                      (1.0, "at 1")])
def test_masked_quantile_matches_numpy(q, t_kind):
    """Rows of 11 valid values put the interpolation weight t below, at
    and above 0.5 (numpy's two formulas), plus rows with 1 and 0 valid
    values (0 by convention)."""
    rng = np.random.default_rng(3)
    vals = rng.random((6, 20)) * 100.0
    mask = np.zeros((6, 20), dtype=bool)
    for i, n_valid in enumerate((11, 11, 20, 5, 1, 0)):
        mask[i, rng.permutation(20)[:n_valid]] = True
    got = pq.masked_quantile(torch.from_numpy(vals), torch.from_numpy(mask),
                             q).numpy()
    want = np.array([np.quantile(v[m], q) if m.any() else 0.0
                     for v, m in zip(vals, mask)])
    np.testing.assert_array_equal(got, want)
    t = q * 10 - np.floor(q * 10)
    assert {"below": t < 0.5, "at": t == 0.5,
            "above": t > 0.5, "at 0": t == 0.0, "at 1": t == 0.0}[t_kind]


def test_argmin_takes_the_first_of_a_tie():
    """The decide walk's argmin picks the first candidate of an exact tie,
    as ``np.argmin`` does on the host."""
    scores = torch.tensor([[2.0, 1.0, 1.0], [1.0, 1.0, 1.0],
                           [3.0, 3.0, 0.5]], dtype=torch.float64)
    np.testing.assert_array_equal(torch.argmin(scores, dim=1).numpy(),
                                  np.argmin(scores.numpy(), axis=1))
    assert torch.argmin(scores, dim=1).tolist() == [1, 0, 2]


def test_tied_base_scores_hold_the_first_candidate(ref):
    """With every candidate scoring the same, the fused walk places the
    first and never switches (a gain of 0 never clears the gate)."""
    sim = _sim(_both(ref, "quiet")["port"])
    rcfg = pt.ReplanConfig(mode="periodic", hysteresis=0.0,
                           migration_weight_s_per_mb=0.0)
    bs = np.full((sim.n_topo_slots, sim.n_plans), 0.25)
    (out,) = sim.run_replan_grid(rcfg, base_scores=bs)
    assert (out.report.schedule.slot_plan == 0).all()
    assert out.report.n_switches == 0
    np.testing.assert_array_equal(
        np.stack([d.scores for d in out.report.decisions]), 0.25)


def test_penalty_base_scores_and_schedule_match_reference(ref):
    """``backlog_penalty_s``, ``replan_base_scores`` and
    ``build_replan_schedule`` (with a seeded backlog observation) bitwise
    the reference's."""
    import repro.traffic.replan as rr
    w = _both(ref, "switch")
    (topo, act, plans, _, qcfg, c, t) = w["ref"]
    (ptopo, pact, pplans, _, pqcfg, _, _) = w["port"]
    rng = np.random.default_rng(9)
    backlog = (rng.random(topo.n_sats) * 3.0).astype(np.float32)
    for p, pp in zip(plans, pplans):
        assert pt.backlog_penalty_s(pp, backlog) \
            == rr.backlog_penalty_s(p, backlog)
    rcfg = t.ReplanConfig(mode="backlog", bytes_per_expert=1e6)
    prcfg = pt.ReplanConfig(mode="backlog", bytes_per_expert=1e6)
    wl, comp = c.MoEWorkload.llama_moe_3p5b(), c.ComputeConfig()
    pwl, pcomp = pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig()
    np.testing.assert_array_equal(
        pt.replan_base_scores(pplans, ptopo, pact, pwl, pcomp,
                              np.random.default_rng(5), prcfg,
                              device="cpu"),
        rr.replan_base_scores(plans, topo, act, wl, comp,
                              np.random.default_rng(5), rcfg))

    def backlog_at(k, t_s, cur):
        return (np.random.default_rng(k * 7 + max(cur, 0)).random(
            topo.n_sats) * 4.0).astype(np.float32)
    want = rr.build_replan_schedule(
        plans, topo, act, wl, comp, np.random.default_rng(6), rcfg,
        horizon_s=95.0, slot_period_s=qcfg.slot_period_s,
        backlog_at=backlog_at)
    got = pt.build_replan_schedule(
        pplans, ptopo, pact, pwl, pcomp, np.random.default_rng(6), prcfg,
        horizon_s=95.0, slot_period_s=pqcfg.slot_period_s,
        backlog_at=backlog_at, device="cpu")
    assert want.n_switches >= 1
    _assert_same_report(want, got)
    assert got.total_migration_bytes == want.total_migration_bytes


@pytest.mark.parametrize("bad", [dict(mode="sometimes"),
                                 dict(period_slots=0), dict(hysteresis=-0.1),
                                 dict(migration_weight_s_per_mb=-1.0),
                                 dict(n_tokens=0),
                                 dict(controller_iterations=0)])
def test_replan_config_refuses_what_the_reference_refuses(ref, bad):
    traffic, _ = ref
    with pytest.raises(ValueError) as want:
        traffic.ReplanConfig(**bad)
    with pytest.raises(ValueError) as got:
        pt.ReplanConfig(**bad)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# The host loop and the joint control plane against the reference's
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["backlog", "periodic", "off"])
def test_replan_matches_reference_all_modes(ref, mode):
    """The quiet world in every mode: the port's host loop and fused path
    each bitwise the reference's, and the fused path its own host loop."""
    w = _both(ref, "quiet")
    r_host, r_fused = _loops(w["ref"], dict(mode=mode))
    p_host, p_fused = _loops(w["port"], dict(mode=mode))
    _assert_same_outcome(r_host, p_host)
    _assert_same_outcome(r_fused, p_fused)
    _assert_same_report(p_host.report, p_fused.report)
    _assert_same_result(p_host.result, p_fused.result)
    assert (p_fused.probe is not None) == (mode == "backlog")
    assert p_host.report.trace is None
    assert isinstance(p_fused.report.trace, DecisionTrace)


@pytest.mark.parametrize("gated", [False, True])
def test_replan_matches_reference_switching_world(ref, switch_loops, gated):
    """The congested world switches plans; with the hysteresis and
    migration-cost gates on, they suppress switches identically."""
    w, (r_host, r_fused), (p_host, p_fused) = switch_loops
    if gated:
        gates = dict(SWITCH_GATES, hysteresis=0.02,
                     migration_weight_s_per_mb=0.001)
        free = r_host.report.n_switches
        r_host, r_fused = _loops(w["ref"], gates)
        p_host, p_fused = _loops(w["port"], gates)
        assert r_host.report.n_switches <= free
    else:
        assert r_host.report.n_switches >= 3
    _assert_same_outcome(r_host, p_host)
    _assert_same_outcome(r_fused, p_fused)
    _assert_same_report(p_host.report, p_fused.report)
    _assert_same_result(p_host.result, p_fused.result)


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_replan_matches_reference_with_admission(ref, policy):
    """Admission and the replan score read the same backlog: decisions,
    served, shed and retry sets and latencies bitwise the reference's,
    fused and host loop."""
    w = _both(ref, "switch", dict(policy=policy, ttft_target_s=60.0))
    r_host, r_fused = _loops(w["ref"], SWITCH_GATES)
    p_host, p_fused = _loops(w["port"], SWITCH_GATES)
    assert r_host.report.n_switches >= 1
    _assert_same_outcome(r_host, p_host)
    _assert_same_outcome(r_fused, p_fused)
    _assert_same_report(p_host.report, p_fused.report)
    _assert_same_result(p_host.result, p_fused.result)
    assert all(p.shed is not None for p in p_fused.result.plans)


def test_controller_grid_matches_reference_and_per_cell_runs(ref):
    """A 2 x 2 x 2 grid (cadence x migration price x TTFT target, AIMD)
    in one call: bitwise the reference's grid, and each cell bitwise the
    port's own one-cell call at that cell's configuration."""
    adm = dict(policy="aimd", ttft_target_s=60.0)
    w = _both(ref, "quiet", adm)
    grid = dict(cadences=[1, 2], mig_weights=[0.0, 0.1],
                ttft_targets=[30.0, 90.0])
    outs = {}
    for name in ("ref", "port"):
        sim = _sim(w[name])
        t = w[name][-1]
        outs[name] = sim.run_many(
            replan=t.ReplanConfig(**SWITCH_GATES),
            replan_rng=np.random.default_rng(5), **grid)
    assert len(outs["port"]) == 8
    for a, b in zip(outs["ref"], outs["port"]):
        _assert_same_outcome(a, b)
    sim = _sim(w["port"])
    scores = pt.replan_base_scores(
        sim.plans, sim.topo, sim.activation, sim.workload, sim.compute,
        np.random.default_rng(5), pt.ReplanConfig(**SWITCH_GATES),
        device="cpu")
    cells = [(c, m, tt) for c in grid["cadences"]
             for m in grid["mig_weights"] for tt in grid["ttft_targets"]]
    for (cad, mw, tt), got in zip(cells, outs["port"]):
        rcfg = pt.ReplanConfig(**dict(SWITCH_GATES, period_slots=cad,
                                      migration_weight_s_per_mb=mw))
        (one,) = sim.run_replan_grid(rcfg, base_scores=scores,
                                     ttft_targets=[tt])
        _assert_same_outcome(one, got)
        ks = [d.boundary for d in got.report.decisions]
        assert ks[0] == 0 and all(k % cad == 0 for k in ks[1:])


@pytest.mark.parametrize("case", ["batching", "batching_aimd",
                                  "probes_aimd", "periodic"])
def test_replan_host_loop_options_match_reference(ref, case):
    """The host loop under the options the joint control plane refuses
    (continuous batching at ``b_max=4``, with and without AIMD; probe
    rings under AIMD) on the quiet world, and periodic mode on the
    switching world (host loop and joint control plane): decisions and
    results bitwise the reference's."""
    from repro.obs import ProbeConfig

    from repro_torch.obs import ProbeConfig as PProbeConfig
    traffic, _ = ref
    adm = None if case in ("batching", "periodic") else \
        dict(policy="aimd", ttft_target_s=60.0)
    w = _both(ref, "switch" if case == "periodic" else "quiet", adm)
    kw = {"ref": {}, "port": {}}
    if case.startswith("batching"):
        kw = {"ref": dict(batching=traffic.BatchingConfig(b_max=4)),
              "port": dict(batching=pt.BatchingConfig(b_max=4))}
    elif case == "probes_aimd":
        kw = {"ref": dict(probes=ProbeConfig()),
              "port": dict(probes=PProbeConfig())}
    gates = dict(SWITCH_GATES, mode="periodic") if case == "periodic" \
        else dict(SWITCH_GATES)
    outs = {}
    for name in ("ref", "port"):
        topo, act, plans, req, qcfg, c, t = w[name]
        extra = dict(kw[name], device="cpu") if t is pt else kw[name]
        outs[name] = t.replan_traffic(
            plans, topo, act, c.MoEWorkload.llama_moe_3p5b(),
            c.ComputeConfig(), req, np.random.default_rng(4),
            t.ReplanConfig(**gates), qcfg, **extra)
    _assert_same_outcome(outs["ref"], outs["port"])
    if case == "periodic":
        _, p_fused = _loops(w["port"], gates)
        _assert_same_report(outs["port"].report, p_fused.report)
        _assert_same_result(outs["port"].result, p_fused.result)
        assert len(outs["port"].report.decisions) > 1
    if case == "probes_aimd":
        assert outs["port"].sim.last_probes is not None
    if adm is not None:
        assert all(p.shed is not None for p in outs["port"].result.plans)


@pytest.mark.parametrize("case", ["pid_2x3", "zipped_inf"])
def test_controller_grid_axes_match_reference(ref, case):
    """``run_many(replan=)`` grids against the reference's: under PID over
    2 cadences x 3 TTFT targets, and under AIMD with zipped TTFT/TPOT
    target axes, one of them infinite in each cell."""
    if case == "pid_2x3":
        adm = dict(policy="pid", ttft_target_s=60.0)
        grid = dict(cadences=[1, 2], ttft_targets=[30.0, 60.0, 90.0])
    else:
        adm = dict(policy="aimd", ttft_target_s=60.0)
        grid = dict(cadences=[1], ttft_targets=[30.0, np.inf],
                    tpot_targets=[np.inf, 5.0])
    w = _both(ref, "quiet", adm)
    outs = {}
    for name in ("ref", "port"):
        t = w[name][-1]
        outs[name] = _sim(w[name]).run_many(
            replan=t.ReplanConfig(**SWITCH_GATES),
            replan_rng=np.random.default_rng(5), **grid)
    n_cells = len(grid["cadences"]) * len(grid["ttft_targets"])
    assert len(outs["port"]) == n_cells
    for a, b in zip(outs["ref"], outs["port"], strict=True):
        _assert_same_outcome(a, b)


def test_run_replan_matches_reference_and_leaves_run_unchanged(ref):
    """``run(replan=)`` bitwise the reference's; a plain ``run()`` after
    it is bitwise the one before it."""
    w = _both(ref, "quiet")
    sim, psim = _sim(w["ref"]), _sim(w["port"])
    base = psim.run()
    traffic = w["ref"][-1]
    want = sim.run(replan=traffic.ReplanConfig(mode="backlog"),
                   replan_rng=np.random.default_rng(5))
    got = psim.run(replan=pt.ReplanConfig(mode="backlog"),
                   replan_rng=np.random.default_rng(5))
    _assert_same_outcome(want, got)
    assert got.sim is psim
    again = psim.run()
    _assert_same_result(base, again)
    for pa, pb in zip(base.plans, again.plans):
        np.testing.assert_array_equal(pa.station_util, pb.station_util)


@pytest.mark.parametrize("case", [
    "batching", "probes", "per_satellite", "schedules",
    "targets_without_admission", "gain_scale", "run_with_active",
    "run_many_with_active", "axes_without_replan", "base_scores_shape",
    "cadence_zero"])
def test_run_replan_grid_refuses_what_the_reference_refuses(ref, case):
    """Each refusal with the reference's exception type and message."""
    traffic, _ = ref
    import repro.core as rc
    from repro.obs import ProbeConfig

    from repro_torch.obs import ProbeConfig as PProbeConfig
    w = _both(ref, "quiet")
    kw = pkw = {}
    world, pworld = w["ref"], w["port"]
    if case == "batching":
        kw = dict(batching=traffic.BatchingConfig())
        pkw = dict(batching=pt.BatchingConfig())
    elif case == "probes":
        kw, pkw = dict(probes=ProbeConfig()), dict(probes=PProbeConfig())
    elif case == "schedules":
        world = world[:2] + ([rc.PlanSchedule(
            plans=world[2], slot_plan=np.array([0, 1] * 5), name="flip")],) \
            + world[3:]
        pworld = pworld[:2] + ([pc.PlanSchedule(
            plans=pworld[2], slot_plan=np.array([0, 1] * 5),
            name="flip")],) + pworld[3:]
    elif case == "gain_scale":
        adm = dict(policy="pid", gain_scale=(1.0, 2.0))
        w = _both(ref, "quiet", adm)
        world, pworld = w["ref"], w["port"]
    if case == "per_satellite":
        # The calibrated table's model: 8 experts a layer.
        sims = _pair(ref, rate=0.3, horizon=30.0, n_experts=8,
                     calibrated=True)
    else:
        sims = (_sim(world, **kw), _sim(pworld, **pkw))
    n_slots, n_plans = sims[1].n_topo_slots, sims[1].n_plans
    errors = []
    for sim, t in zip(sims, (traffic, pt)):
        rcfg = t.ReplanConfig(mode="backlog")
        bs = np.zeros((n_slots, n_plans))
        call = {
            "targets_without_admission": lambda: sim.run_replan_grid(
                rcfg, base_scores=bs, ttft_targets=[1.0]),
            "run_with_active": lambda: sim.run(
                np.ones(sim.n_requests, dtype=bool), replan=rcfg),
            "run_many_with_active": lambda: sim.run_many(
                np.ones((1, sim.n_requests), dtype=bool), replan=rcfg,
                base_scores=bs),
            "axes_without_replan": lambda: sim.run_many(
                np.ones((1, sim.n_requests), dtype=bool), cadences=[1]),
            "base_scores_shape": lambda: sim.run_replan_grid(
                rcfg, base_scores=bs[:, :1]),
            "cadence_zero": lambda: sim.run_replan_grid(
                rcfg, base_scores=bs, cadences=[0]),
        }.get(case, lambda: sim.run_replan_grid(
            rcfg, base_scores=np.zeros((n_slots, sim.n_plans))))
        with pytest.raises((ValueError, NotImplementedError)) as err:
            call()
        errors.append(err)
    assert errors[1].type is errors[0].type
    assert str(errors[1].value) == str(errors[0].value)


# --------------------------------------------------------------------- #
# The recorder's replan events
# --------------------------------------------------------------------- #


def _events(events):
    return [(e.t_s, e.kind, e.name, e.plan, e.args) for e in events]


def test_replan_and_joint_events_match_reference(ref, switch_loops):
    """``replan_events``, ``joint_decision_events``, ``ReplanReport
    .events`` and the flight log of the schedule row with ``replan=``,
    all equal to the reference's on the switching world's outcomes."""
    from repro.obs import build_flight_log as ref_flight_log
    from repro.obs import joint_decision_events as ref_joint
    from repro.obs import replan_events as ref_replan
    w, (r_host, r_fused), (p_host, p_fused) = switch_loops
    period = w["port"][4].slot_period_s
    for a, b in ((r_host, p_host), (r_fused, p_fused)):
        assert _events(replan_events(b.report, period)) \
            == _events(ref_replan(a.report, period))
        assert _events(joint_decision_events(b.report)) \
            == _events(ref_joint(a.report))
        assert _events(b.report.events(period)) \
            == _events(a.report.events(period))
    assert joint_decision_events(p_host.report) == []
    assert sum(e.name == "joint switch"
               for e in joint_decision_events(p_fused.report)) \
        == p_fused.report.n_switches > 0
    want = ref_flight_log(r_fused.sim, r_fused.result, replan=r_fused.report)
    got = build_flight_log(p_fused.sim, p_fused.result,
                           replan=p_fused.report)
    assert _events(got.events) == _events(want.events)
    assert got.plan == want.plan == len(got.plan_names) - 1
    for rg, rw in zip(got.requests, want.requests):
        np.testing.assert_array_equal(
            [rg.served, rg.shed, rg.ingress_s, rg.ttft_s, rg.e2e_s],
            [rw.served, rw.shed, rw.ingress_s, rw.ttft_s, rw.e2e_s])
        np.testing.assert_array_equal(rg.layer_zero_s, rw.layer_zero_s)
    with pytest.raises(ValueError, match="no replan report"):
        build_flight_log(p_fused.sim, p_fused.result)


# --------------------------------------------------------------------- #
# Per-entry tables of the admission kernels' plain versions
# --------------------------------------------------------------------- #


def _per_entry_inputs(n_f=3, n_p=2, n_s=3, n_l=3, n_i=4, n_c=17, n_bins=60):
    rng = np.random.default_rng(11)
    wait = torch.from_numpy((rng.random((n_bins, n_f, n_c)) * 2.0)
                            .astype(np.float32))
    work_last = torch.from_numpy((rng.random((n_f, n_c)) * 0.5)
                                 .astype(np.float32))
    gw = torch.from_numpy(rng.integers(0, n_c, (n_s, n_f, n_p, n_l)))
    ex = torch.from_numpy(rng.integers(0, n_c, (n_s, n_f, n_p, n_l * n_i)))
    bin_map = torch.from_numpy(np.repeat(np.arange(n_s), n_bins // n_s + 1)
                               [:n_bins])
    return wait, work_last, gw, ex, bin_map


def test_qhat_trace_and_window_per_entry_match_entry_loop():
    """Per-entry station maps (NS, F, P, ...) give each entry what the
    shared-table call gives it alone."""
    wait, work_last, gw, ex, bin_map = _per_entry_inputs()
    ctrl = torch.from_numpy(np.arange(60) % 7 == 6)
    seg, n_ctrl = window_mod.control_segments(ctrl)
    cap, dt = torch.tensor(1.5), torch.tensor(0.05)
    got = window_mod.qhat_trace(wait, work_last, cap, dt, gw, ex, bin_map)
    win = window_mod.admission_window(wait, work_last, 1.5, 0.05, gw, ex,
                                      bin_map, seg, n_ctrl)
    for f in range(wait.shape[1]):
        one = window_mod.qhat_trace(wait[:, f:f + 1], work_last[f:f + 1],
                                    cap, dt, gw[:, f], ex[:, f], bin_map)
        np.testing.assert_array_equal(got[:, f:f + 1].numpy(), one.numpy())
        one_win = window_mod.admission_window(
            wait[:, f:f + 1], work_last[f:f + 1], 1.5, 0.05, gw[:, f],
            ex[:, f], bin_map, seg, n_ctrl)
        np.testing.assert_array_equal(win[:, f:f + 1].numpy(),
                                      one_win.numpy())
    # Per-entry tables that repeat one entry's are the shared call.
    rep = gw[:, :1].expand_as(gw), ex[:, :1].expand_as(ex)
    np.testing.assert_array_equal(
        window_mod.qhat_trace(wait, work_last, cap, dt, *rep,
                              bin_map).numpy(),
        window_mod.qhat_trace(wait, work_last, cap, dt, gw[:, 0], ex[:, 0],
                              bin_map).numpy())


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_admission_ctrl_per_entry_matches_entry_loop(policy):
    """Per-entry anchors (F, P, G) and (F, P) give each entry what the
    shared-anchor call gives it alone, AIMD and PID."""
    rng = np.random.default_rng(12)
    n_ctrl, n_f, n_p, n_g = 40, 3, 2, 2

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))
    win = f32(rng.random((n_ctrl, n_f, n_p)) * 3.0)
    ttft0 = f32(rng.random((n_f, n_p, n_g)))
    tpot0 = f32(rng.random((n_f, n_p)) * 0.1)
    admit0 = torch.ones((n_f, n_p, n_g))
    tt, tp = f32([2.0, 2.5, 3.0]), f32([np.inf, 1.0, np.inf])
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=f32([1.0, 1.5]))
    got = ctrl_mod.admission_ctrl(win, ttft0, tpot0, admit0, tt, tp, **kw)
    for f in range(n_f):
        one = ctrl_mod.admission_ctrl(win[:, f:f + 1], ttft0[f], tpot0[f],
                                      admit0[f:f + 1], tt[f:f + 1],
                                      tp[f:f + 1], **kw)
        np.testing.assert_array_equal(got[:, f:f + 1].numpy(), one.numpy())
    with pytest.raises(ValueError, match="shapes"):
        ctrl_mod.admission_ctrl(win, ttft0[:2], tpot0, admit0, tt, tp, **kw)


def test_ctrl_tables_gated_table_is_row_grouped_in_event_order(ref):
    """The gated table is grouped by schedule row (``ch_row_ptr``), and
    within a row keeps the event-major order (ascending event, plan
    within event), so each cell sums in a host evaluation's order."""
    sim = _sim(_both(ref, "switch")["port"])
    ct = sim._ctrl_tables()
    srow, ptr = ct["ch_srow"], ct["ch_row_ptr"]
    assert (np.diff(srow) >= 0).all()
    assert ptr[0] == 0 and ptr[-1] == srow.size
    assert ptr.shape == (ct["n_rows_sched"] + 1,)
    np.testing.assert_array_equal(srow[ptr[:-1][np.diff(ptr) > 0]],
                                  np.flatnonzero(np.diff(ptr) > 0))
    # One three-key sort (row, then event, then plan) gives the table.
    srow_of = np.searchsorted(ct["srows"], sim.ev_chunk_station)
    ev_local = sim._rep % (sim._n_events // sim.n_plans)
    order = np.lexsort((sim.ev_chunk_plan, ev_local, srow_of))
    np.testing.assert_array_equal(ct["ch_srow"], srow_of[order])
    np.testing.assert_array_equal(ct["ch_plan"], sim.ev_chunk_plan[order])
    np.testing.assert_array_equal(ct["ch_work"], sim.ev_chunk_work[order])
    np.testing.assert_array_equal(ct["ch_bins0"], sim._chunk_bins0[order])
    # Its deposit is the event-major table's, bit for bit.
    from repro_torch.kernels.deposit import deposit_plain
    em = np.lexsort((sim.ev_chunk_plan, ev_local))
    gate = sim.ev_chunk_plan == 1

    def plane(idx):
        return deposit_plain(
            torch.from_numpy(srow_of[idx]),
            torch.from_numpy(sim._chunk_bins0[idx]),
            torch.from_numpy(sim.ev_chunk_work[idx] * gate[idx]),
            ct["n_rows_sched"], sim.n_bins).numpy()
    np.testing.assert_array_equal(plane(order), plane(em))
