"""The port's scenario registry and runner (``repro_torch.traffic
.scenarios``) against the reference's, on the CPU.

Both packages get the same seeded numpy inputs on the world of
``tests/test_torch_replan.py`` (8 x 12 satellites, 10 slots, 4 MoE layers
of 4 experts, top-2, two plans, the 8 default gateways).  Held bit for
bit: every registry entry's ``requests()`` and ``queue_config()``, the
failure storm (degraded plans, failed positions, migration bytes and
moved experts) and the re-placement decisions; the fleet results at
``tests/test_torch_fleet.py``'s criterion (identical served sets, goodput
to 1e-9, latencies to rtol 1e-5) with identical shed and retry sets.  The
reference's ``repro.traffic`` comes through the ``ref`` fixture of
``tests/test_torch_fleet.py`` (the ``enable_x64`` shim).
"""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as pc
import repro_torch.traffic as pt
from test_torch_fleet import _assert_parity, ref  # noqa: F401
from test_torch_replan import _assert_same_report

NAMES = ("smoke", "steady-state", "diurnal-peak", "regional-hotspot",
         "failure-storm", "regional-hotspot-controlled",
         "failure-storm-controlled", "regional-hotspot-replan",
         "failure-storm-replan")


def _world(c, t, n_experts=4):
    cfg = c.ConstellationConfig.scaled(8, 12, n_slots=10, survival_prob=1.0)
    con = c.Constellation(cfg)
    topo = c.sample_topology(con, c.LinkConfig(), np.random.default_rng(0))
    act = c.ActivationModel.zipf(4, n_experts, 2, seed=1)
    plans = [c.spacemoe_plan(con, topo, act),
             c.rand_intra_cg_plan(con.cfg, 4, n_experts,
                                  np.random.default_rng(7))]
    ground = t.build_ground_segment(con, c.LinkConfig(),
                                    min_elevation_deg=10.0)
    return dict(con=con, topo=topo, act=act, plans=plans, ground=ground,
                wl=c.MoEWorkload.llama_moe_3p5b(), comp=c.ComputeConfig())


def _both(ref, n_experts=4):
    """{"ref"|"port": (core, traffic, world, the simulators' keywords)}."""
    import repro.core as rc
    traffic, _ = ref
    return {"ref": (rc, traffic, _world(rc, traffic, n_experts), {}),
            "port": (pc, pt, _world(pc, pt, n_experts), {"device": "cpu"})}


def _same_batch(a, b):
    for name in ("arrival_s", "prompt_len", "decode_len", "station"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)


def _same_admission(a, b):
    for pa, pb in zip(a.plans, b.plans, strict=True):
        assert (pa.shed is None) == (pb.shed is None)
        if pa.shed is not None:
            np.testing.assert_array_equal(pa.shed, pb.shed)
            np.testing.assert_array_equal(pa.retries, pb.retries)


def test_scenario_names_match_reference(ref):
    traffic, _ = ref
    assert tuple(pt.SCENARIOS) == tuple(traffic.SCENARIOS) == NAMES
    for name in NAMES:
        assert pt.get_scenario(name).name == name
    with pytest.raises(KeyError, match="unknown scenario 'nope'"):
        pt.get_scenario("nope")


@pytest.mark.parametrize("name", NAMES)
def test_registry_entry_matches_reference(ref, name):
    """Fields, ``requests()`` (one gateway and eight, rate x 1 and x 3)
    and ``queue_config()`` (the constellation's period or the scenario's
    own), bit for bit."""
    traffic, _ = ref
    a, b = traffic.get_scenario(name), pt.get_scenario(name)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("admission", "replan", "slo"):
            assert (va is None) == (vb is None)
            if va is not None:
                assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        else:
            assert va == vb, f.name
    for n_st, scale in ((1, 1.0), (8, 3.0)):
        _same_batch(a.requests(np.random.default_rng(3), n_st, scale),
                    b.requests(np.random.default_rng(3), n_st, scale))
    for period in (None, 123.0):
        qa, qb = a.queue_config(period), b.queue_config(period)
        for f in dataclasses.fields(qa):
            va, vb = getattr(qa, f.name), getattr(qb, f.name)
            if f.name == "admission":
                assert (va is None) == (vb is None)
                if va is not None:
                    assert dataclasses.asdict(va) == dataclasses.asdict(vb)
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("frac,n_plans", [(0.25, 2), (0.5, 1)])
def test_apply_failure_storm_matches_reference(ref, frac, n_plans):
    w = _both(ref)
    out = {}
    for key, (_c, t, world, _kw) in w.items():
        out[key] = t.apply_failure_storm(
            world["plans"][:n_plans], world["act"], np.random.default_rng(9),
            failure_frac=frac, bytes_per_expert=2.5e6)
    a, b = out["ref"], out["port"]
    for fa, fb in zip(a.failed_positions, b.failed_positions, strict=True):
        np.testing.assert_array_equal(fa, fb)
    for pa, pb in zip(a.degraded_plans, b.degraded_plans, strict=True):
        assert pa.name == pb.name
        assert type(pb).__name__ == "MultiExpertPlan"
        assert pa.experts_per_sat == pb.experts_per_sat
        np.testing.assert_array_equal(pa.gateways, pb.gateways)
        np.testing.assert_array_equal(pa.expert_sats, pb.expert_sats)
    assert a.migration_bytes == b.migration_bytes
    assert a.moved_experts == b.moved_experts
    with pytest.raises(ValueError, match="no surviving"):
        pt.apply_failure_storm(w["port"][2]["plans"], w["port"][2]["act"],
                               np.random.default_rng(9), failure_frac=1.0)


def test_make_sim_matches_reference(ref):
    w = _both(ref)
    sims = {}
    for key, (_c, t, world, kw) in w.items():
        sims[key] = t.make_sim(
            t.get_scenario("regional-hotspot"), world["plans"],
            world["topo"], world["act"], world["wl"], world["comp"],
            np.random.default_rng(4), ground=world["ground"],
            constellation=world["con"], rate_scale=6.0, **kw)
    a, b = sims["ref"], sims["port"]
    assert b.device.type == "cpu"
    assert b.qcfg == dataclasses.replace(
        b.qcfg, slot_period_s=a.qcfg.slot_period_s)
    _same_batch(a.requests, b.requests)
    _assert_parity(a.run(), b.run())


def _run(ref, name, ctrl, rate_scale=8.0, **sim_kw):
    """run_scenario in both packages on a 40 s cut of ``name`` (storm at
    20 s, 10 s slots for the re-placement entries)."""
    out = {}
    for key, (_c, t, world, kw) in _both(ref).items():
        base = t.get_scenario(name)
        sc = dataclasses.replace(
            base, horizon_s=40.0, tail_s=30.0,
            slot_period_s=10.0 if base.replan is not None else None,
            failure_at_s=20.0 if base.failure_at_s is not None else None)
        out[key] = t.run_scenario(
            sc, world["plans"], world["topo"], world["act"], world["wl"],
            world["comp"], np.random.default_rng(4), ground=world["ground"],
            constellation=world["con"], rate_scale=rate_scale, ctrl=ctrl,
            **kw, **sim_kw)
    return out["ref"], out["port"]


@pytest.mark.parametrize("name,ctrl", [
    ("smoke", "host"), ("regional-hotspot-controlled", "host"),
    ("failure-storm-replan", "host"), ("failure-storm-replan", "fused")])
def test_run_scenario_matches_reference(ref, name, ctrl):
    a, b = _run(ref, name, ctrl)
    assert b.scenario.name == name
    _assert_parity(a.result, b.result)
    _same_admission(a.result, b.result)
    assert (a.post_failure is None) == (b.post_failure is None)
    if a.post_failure is not None:
        _assert_parity(a.post_failure, b.post_failure)
        assert a.storm.migration_bytes == b.storm.migration_bytes
        assert a.storm.moved_experts == b.storm.moved_experts
    for rep in ("replan", "post_replan"):
        ra, rb = getattr(a, rep), getattr(b, rep)
        assert (ra is None) == (rb is None)
        if ra is not None:
            _assert_same_report(ra, rb)
    assert b.sim.device.type == "cpu"
    if name == "smoke":
        assert b.result.plans[0].served.any()
    if name == "regional-hotspot-controlled":
        assert b.result.plans[0].shed is not None


def test_run_scenario_fused_matches_host_in_the_port(ref):
    """The joint control plane's decisions are the host loop's, bit for
    bit, on the storm scenario's two phases."""
    _, host = _run(ref, "failure-storm-replan", "host")
    _, fused = _run(ref, "failure-storm-replan", "fused")
    _assert_same_report(host.replan, fused.replan)
    _assert_same_report(host.post_replan, fused.post_replan)
    _assert_parity(host.result, fused.result)


@pytest.mark.parametrize("option", ["batching", "probes", "calibrated",
                                    "pid_gains"])
def test_fused_scenario_refusals_match_reference(ref, option):
    """``ctrl="fused"`` under batching, probes, calibrated per-satellite
    service or per-plan PID gains raises NotImplementedError in both
    packages; the host loop takes the same scenario."""
    import repro.core as rc
    from repro.obs import ProbeConfig

    from repro_torch.obs import ProbeConfig as PProbeConfig
    traffic, _ = ref
    kw = {"ref": {}, "port": {}}
    name = "regional-hotspot-replan"
    if option == "batching":
        kw = {"ref": dict(batching=traffic.BatchingConfig(b_max=4)),
              "port": dict(batching=pt.BatchingConfig(b_max=4))}
    elif option == "probes":
        kw = {"ref": dict(probes=ProbeConfig()),
              "port": dict(probes=PProbeConfig())}
    elif option == "calibrated":
        kw = {"ref": dict(service_model=rc.ServiceModel.calibrated(
                  rc.MoEWorkload.llama_moe_3p5b(), rc.ComputeConfig(),
                  rc.load_table("llama-moe-3.5b"))),
              "port": dict(service_model=pc.ServiceModel.calibrated(
                  pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig(),
                  pc.load_table("llama-moe-3.5b")))}
    messages = []
    worlds = _both(ref, n_experts=8 if option == "calibrated" else 4)
    for key, (_c, t, world, dev) in worlds.items():
        sc = dataclasses.replace(t.get_scenario(name), horizon_s=20.0,
                                 tail_s=10.0, slot_period_s=10.0)
        if option == "pid_gains":
            sc = dataclasses.replace(sc, admission=t.AdmissionConfig(
                policy="pid", gain_scale=(1.0, 0.5)))
        with pytest.raises(NotImplementedError) as exc:
            t.run_scenario(sc, world["plans"], world["topo"], world["act"],
                           world["wl"], world["comp"],
                           np.random.default_rng(4), ground=world["ground"],
                           ctrl="fused", **dev, **kw[key])
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_run_scenario_refuses_unknown_controller_and_empty_phase(ref):
    w = _both(ref)["port"][2]
    args = (w["plans"], w["topo"], w["act"], w["wl"], w["comp"],
            np.random.default_rng(4))
    with pytest.raises(ValueError, match="unknown controller"):
        pt.run_scenario("smoke", *args, ctrl="gpu", device="cpu")
    sc = dataclasses.replace(pt.get_scenario("failure-storm"),
                             failure_at_s=0.0)
    with pytest.raises(ValueError, match="precedes every arrival"):
        pt.run_scenario(sc, *args, device="cpu")
