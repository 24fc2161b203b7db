"""The port's fleet simulator against the reference's, on the CPU.

Both packages get the same seeded numpy inputs (world, plans, requests,
the FleetSim rng) on a small world: 8 x 12 satellites, 10 slots, 4 MoE
layers, top-2.  The port runs on the CPU, so its ``deposit`` and
``backlog_scan`` run their plain versions.  Parity criterion (the one the
reference holds its own fused and legacy paths to): identical served
sets, goodput equal to 1e-9, TTFT/E2E per request and as quantiles
within rtol 1e-5.

Under jax 0.9 ``repro.traffic`` does not import (it asks for
``jax.experimental.enable_x64``, which jax 0.9 dropped).  The module
fixture ``ref`` supplies that name with ``pytest.MonkeyPatch`` while it
imports the reference's traffic modules, and on teardown takes them out
of ``sys.modules`` again, so nothing here changes how the JAX package's
own test files import.
"""
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as pc
import repro_torch.traffic as pt
from repro.core import (ActivationModel, ComputeConfig, Constellation,
                        ConstellationConfig, LinkConfig, MoEWorkload,
                        PlanSchedule, ServiceModel, load_table,
                        rand_intra_cg_plan, sample_topology, spacemoe_plan)
from repro_torch.traffic import queueing as pq

N_LAYERS, TOP_K = 4, 2
REQ_KW = dict(n_stations=1, prompt_median=4, prompt_max=16, decode_mean=4,
              decode_max=8)


@pytest.fixture(scope="module")
def ref():
    """The reference's ``repro.traffic`` (imported under the x64 shim)."""
    import jax
    import jax.experimental
    before = set(sys.modules)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64",
               lambda v=True: jax.enable_x64(v), raising=False)
    try:
        import repro.traffic as traffic
        from repro.traffic import queueing
        yield traffic, queueing
    finally:
        mp.undo()
        for name in set(sys.modules) - before:
            if name == "repro.traffic" or name.startswith("repro.traffic."):
                del sys.modules[name]
        import repro
        if "repro.traffic" not in sys.modules and hasattr(repro, "traffic"):
            delattr(repro, "traffic")


def _worlds(n_experts):
    """(reference world, port world): topology, activation, two plans."""
    cfg = dict(n_slots=10, survival_prob=1.0)
    con = Constellation(ConstellationConfig.scaled(8, 12, **cfg))
    topo = sample_topology(con, LinkConfig(), np.random.default_rng(0))
    act = ActivationModel.zipf(N_LAYERS, n_experts, TOP_K, seed=1)
    plans = [spacemoe_plan(con, topo, act),
             rand_intra_cg_plan(con.cfg, N_LAYERS, n_experts,
                                np.random.default_rng(7))]
    pcon = pc.Constellation(pc.ConstellationConfig.scaled(8, 12, **cfg))
    ptopo = pc.sample_topology(pcon, pc.LinkConfig(),
                               np.random.default_rng(0))
    pact = pc.ActivationModel.zipf(N_LAYERS, n_experts, TOP_K, seed=1)
    pplans = [pc.spacemoe_plan(pcon, ptopo, pact),
              pc.rand_intra_cg_plan(pcon.cfg, N_LAYERS, n_experts,
                                    np.random.default_rng(7))]
    return (topo, act, plans), (ptopo, pact, pplans)


def _pair(ref, *, rate=2.0, horizon=40.0, n_experts=4, qkw=None,
          calibrated=False, schedule=False, req_seed=8):
    """The same FleetSim in both packages."""
    traffic, _ = ref
    (topo, act, plans), (ptopo, pact, pplans) = _worlds(n_experts)
    if schedule:
        plans = [PlanSchedule(plans=plans, slot_plan=np.array([0, 1] * 5),
                              name="flip")]
        pplans = [pc.PlanSchedule(plans=pplans,
                                  slot_plan=np.array([0, 1] * 5),
                                  name="flip")]
    qkw = dict(dict(dt_s=0.05, tail_s=30.0), **(qkw or {}))
    req = traffic.sample_requests(np.random.default_rng(req_seed),
                                  rate_rps=rate, horizon_s=horizon, **REQ_KW)
    preq = pt.sample_requests(np.random.default_rng(req_seed), rate_rps=rate,
                              horizon_s=horizon, **REQ_KW)
    wl, pwl = MoEWorkload.llama_moe_3p5b(), pc.MoEWorkload.llama_moe_3p5b()
    svc = psvc = None
    if calibrated:
        svc = ServiceModel.calibrated(wl, ComputeConfig(),
                                      load_table("llama-moe-3.5b"))
        psvc = pc.ServiceModel.calibrated(pwl, pc.ComputeConfig(),
                                          pc.load_table("llama-moe-3.5b"))
    sim = traffic.FleetSim(plans, topo, act, wl, ComputeConfig(), req,
                           np.random.default_rng(5),
                           qcfg=traffic.QueueConfig(**qkw),
                           service_model=svc)
    psim = pt.FleetSim(pplans, ptopo, pact, pwl, pc.ComputeConfig(), preq,
                       np.random.default_rng(5), qcfg=pt.QueueConfig(**qkw),
                       service_model=psvc, device="cpu")
    return sim, psim


def _assert_parity(res_ref, res_port, rtol=1e-5):
    """Identical served sets, goodput to 1e-9, latencies to rtol."""
    assert len(res_ref.plans) == len(res_port.plans)
    for pr, pp in zip(res_ref.plans, res_port.plans):
        assert pr.plan_name == pp.plan_name
        np.testing.assert_array_equal(pr.served, pp.served)
        for which in ("ttft", "e2e", "tpot"):
            for q in (0.5, 0.99):
                a, b = pr.quantile(which, q), pp.quantile(which, q)
                assert (np.isnan(a) and np.isnan(b)) \
                    or np.isclose(a, b, rtol=rtol), (which, q, a, b)
        np.testing.assert_allclose(pp.ttft_s, pr.ttft_s, rtol=rtol,
                                   equal_nan=True)
        np.testing.assert_allclose(pp.e2e_s, pr.e2e_s, rtol=rtol,
                                   equal_nan=True)
        assert np.isclose(pp.goodput_tok_s, pr.goodput_tok_s, rtol=1e-9,
                          atol=0.0)
        assert pp.migration_bytes == pr.migration_bytes


# --------------------------------------------------------------------- #
# Construction: the precompute is the reference's
# --------------------------------------------------------------------- #


def test_construction_tables_match_reference(ref):
    sim, psim = _pair(ref, rate=4.0)
    assert (psim.n_bins, psim.n_rows, psim.n_tokens) == \
        (sim.n_bins, sim.n_rows, sim.n_tokens)
    for name in ("eff_layer", "tok_base", "gw_service", "nan_tok", "draws",
                 "_f_src", "_f_offs", "_f_work", "_f_rowc", "_f_req",
                 "_f_bins0", "_f_fin0", "_active_rows", "_gw_rowc",
                 "_ex_rowc", "_gw_b0", "_ex_b0"):
        np.testing.assert_array_equal(getattr(psim, name),
                                      getattr(sim, name), err_msg=name)


def test_chunk_table_is_row_grouped_and_padded(ref):
    """The compacted chunk table of a thinned sweep: the active chunks of
    each sweep entry, F-major and row-grouped (so ``row_ptr`` describes
    it), padded with zero work to the reference's block size."""
    _, queueing = ref
    sim, psim = _pair(ref, rate=4.0)
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.array([0.3, 1.0])[:, None]
    ct = psim.chunk_table(masks)
    n = ct["n"]
    assert ct["src"].size % queueing._CHUNK_BLOCK == 0
    assert n == sum(int(masks[f, sim._f_req].sum()) for f in range(2))
    assert (np.diff(ct["fprow"][:n]) >= 0).all()
    assert ct["row_ptr"][-1] == n and (ct["work"][n:] == 0).all()
    rows = np.repeat(np.arange(ct["row_ptr"].size - 1),
                     np.diff(ct["row_ptr"]))
    np.testing.assert_array_equal(rows, ct["fprow"][:n])


# --------------------------------------------------------------------- #
# run / run_many / run_legacy against the reference
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("rate,kv", [(2.0, 0), (2.0, 4), (12.0, 0)],
                         ids=["light", "kv-cap", "congested"])
def test_run_matches_reference_analytic(ref, rate, kv):
    sim, psim = _pair(ref, rate=rate, qkw=dict(kv_slots=kv))
    res, pres = sim.run(), psim.run()
    _assert_parity(res, pres)
    if rate > 10:
        assert not pres.plans[0].served.all()        # genuinely congested
    assert psim.last_wait.shape == (2, psim.n_stations, psim.n_bins)
    np.testing.assert_allclose(psim.last_wait, sim.last_wait, rtol=1e-5,
                               atol=1e-6)


def test_run_legacy_matches_reference(ref):
    sim, psim = _pair(ref, rate=12.0)
    _assert_parity(sim.run_legacy(), psim.run_legacy())
    _assert_parity(sim.run_legacy(zero_load=True),
                   psim.run_legacy(zero_load=True))


def test_fused_matches_host_path_in_the_port(ref):
    _, psim = _pair(ref, rate=12.0, qkw=dict(kv_slots=6))
    _assert_parity(psim.run_legacy(), psim.run())


def test_run_many_matches_reference_and_run(ref):
    sim, psim = _pair(ref, rate=8.0)
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.array([0.2, 0.6, 1.0])[:, None]
    many, pmany = sim.run_many(masks), psim.run_many(masks)
    for res, pres in zip(many, pmany):
        _assert_parity(res, pres)
    single = psim.run(active=masks[1])
    _assert_parity(single, pmany[1], rtol=1e-12)


def test_run_matches_reference_calibrated(ref):
    """Calibrated service (the committed llama-moe-3.5b table, 8 experts)
    with a buffer large enough that requests are served."""
    sim, psim = _pair(ref, rate=0.3, horizon=30.0, n_experts=8,
                      calibrated=True, qkw=dict(buffer_s=1e4))
    res, pres = sim.run(), psim.run()
    assert pres.plans[0].served.any()
    _assert_parity(res, pres)
    _assert_parity(sim.run_legacy(), psim.run_legacy())


def test_plan_switch_with_migration_matches_reference(ref):
    sim, psim = _pair(ref, rate=1.0, horizon=60.0, schedule=True,
                      req_seed=3, qkw=dict(slot_period_s=20.0,
                                           migration_bytes_per_expert=1e6))
    assert psim._mig_work.size > 0
    np.testing.assert_array_equal(psim._mig_rm, sim._mig_rm)
    _assert_parity(sim.run(), psim.run())
    _assert_parity(sim.run_legacy(), psim.run_legacy())


def test_saturation_sweep_matches_reference(ref):
    traffic, _ = ref
    sim, psim = _pair(ref, rate=8.0)
    slo = traffic.SLO(ttft_s=20.0, tpot_s=2.0, max_drop=0.5)
    pslo = pt.SLO(ttft_s=20.0, tpot_s=2.0, max_drop=0.5)
    a = traffic.saturation_sweep(sim, slo, np.random.default_rng(2))
    b = pt.saturation_sweep(psim, pslo, np.random.default_rng(2))
    np.testing.assert_array_equal(a.tested_rps, b.tested_rps)
    assert a.sustained_rps == b.sustained_rps
    for name in a.met:
        np.testing.assert_array_equal(a.met[name], b.met[name])


def test_fleet_from_converted_reference_state_matches(ref):
    """The reference's topology, schedule and requests, carried over as
    numbers by ``repro_torch.convert``, give the reference's run."""
    import dataclasses

    from repro_torch import convert
    traffic, _ = ref
    (topo, act, plans), _ = _worlds(4)
    sched = PlanSchedule(plans=plans, slot_plan=np.array([1, 0] * 5),
                         name="flip")
    req = traffic.sample_requests(np.random.default_rng(3), rate_rps=3.0,
                                  horizon_s=60.0, **REQ_KW)
    qkw = dict(dt_s=0.05, tail_s=30.0, slot_period_s=20.0)
    sim = traffic.FleetSim([sched, plans[0]], topo, act,
                           MoEWorkload.llama_moe_3p5b(), ComputeConfig(), req,
                           np.random.default_rng(5),
                           qcfg=traffic.QueueConfig(**qkw))
    psim = pt.FleetSim(
        [convert.schedule_from_arrays(dataclasses.asdict(sched)),
         convert.plan_from_arrays(dataclasses.asdict(plans[0]))],
        convert.topology_from_arrays(dataclasses.asdict(topo)),
        pc.ActivationModel(weights=np.array(act.weights), top_k=act.top_k),
        pc.MoEWorkload.llama_moe_3p5b(), pc.ComputeConfig(),
        convert.requests_from_arrays(dataclasses.asdict(req)),
        np.random.default_rng(5), qcfg=pt.QueueConfig(**qkw), device="cpu")
    _assert_parity(sim.run(), psim.run())


# --------------------------------------------------------------------- #
# requests and metrics: host numpy, bitwise
# --------------------------------------------------------------------- #


def _same_batch(a, b):
    for f in ("arrival_s", "prompt_len", "decode_len", "station"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                      err_msg=f)


@pytest.mark.parametrize("arrival", ["poisson", "diurnal", "hotspot"])
def test_requests_match_reference(ref, arrival):
    traffic, _ = ref
    kw = dict(rate_rps=3.0, horizon_s=200.0, n_stations=3, arrival=arrival,
              diurnal_period_s=400.0, **{k: v for k, v in REQ_KW.items()
                                         if k != "n_stations"})
    a = traffic.sample_requests(np.random.default_rng(11), **kw)
    b = pt.sample_requests(np.random.default_rng(11), **kw)
    _same_batch(a, b)
    np.testing.assert_array_equal(b.request_of_token(), a.request_of_token())
    assert (b.n_requests, b.total_decode_tokens, b.horizon_s) == \
        (a.n_requests, a.total_decode_tokens, a.horizon_s)
    mask = np.arange(a.n_requests) % 3 != 1
    _same_batch(a.subset(mask), b.subset(mask))


def test_stream_requests_match_reference(ref):
    traffic, _ = ref

    def rate(t):
        return 5.0 + 4.0 * np.sin(t / 50.0)
    kw = dict(rate_max_rps=9.0, horizon_s=300.0, n_stations=2, shard_s=70.0,
              prompt_median=8, decode_mean=4)
    a, na = traffic.stream_requests(np.random.default_rng(2), rate, **kw)
    b, nb = pt.stream_requests(np.random.default_rng(2), rate, **kw)
    assert na == nb
    _same_batch(a, b)


def test_metrics_match_reference(ref):
    traffic, _ = ref
    rng = np.random.default_rng(12)
    r = 40
    served = rng.random(r) < 0.8
    ttft = np.where(served, rng.random(r) * 3.0, np.nan)
    e2e = ttft + rng.random(r) * 10.0
    dec = rng.integers(1, 9, r)
    kw = dict(plan_name="p", active=rng.random(r) < 0.9, served=served,
              ttft_s=ttft, tpot_s=(e2e - ttft) / dec, e2e_s=e2e,
              decode_len=dec, station_util=rng.random(5), span_s=37.5,
              token_total_s=rng.random(60), shed=rng.random(r) < 0.1,
              retries=rng.integers(0, 3, r), migration_bytes=2e6)
    a, b = traffic.PlanTraffic(**kw), pt.PlanTraffic(**kw)
    slo_a, slo_b = traffic.SLO(ttft_s=2.0), pt.SLO(ttft_s=2.0)
    for which in ("ttft", "tpot", "e2e"):
        for q in (0.5, 0.9, 0.99):
            assert b.quantile(which, q) == a.quantile(which, q)
    for name in ("n_active", "shed_rate", "drop_rate", "retry_rate",
                 "goodput_tok_s", "offered_rps"):
        assert getattr(b, name) == getattr(a, name), name
    assert b.meets(slo_b) == a.meets(slo_a)
    assert b.row(slo_b) == a.row(slo_a)
    extra = rng.random(r)
    np.testing.assert_array_equal(b.with_added_latency(extra).e2e_s,
                                  a.with_added_latency(extra).e2e_s)
    assert pt.format_table([b.row(slo_b)], "x") == \
        traffic.format_table([a.row(slo_a)], "x")


# --------------------------------------------------------------------- #
# The backlog scan's plain version against the reference's scan
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("cap", [10.0, 0.3])
def test_backlog_scan_plain_matches_fleet_queue_scan(ref, cap):
    _, queueing = ref
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    work = rng.random((2, 7, 400)) * (rng.random((2, 7, 400)) < 0.3) * 0.2
    wait, dropped = queueing._fleet_queue_scan(jnp.asarray(work),
                                               jnp.asarray(cap), 0.05)
    pwait, pdropped = pq._fleet_queue_scan(torch.from_numpy(work), cap, 0.05)
    np.testing.assert_array_equal(pwait.numpy(), np.asarray(wait))
    np.testing.assert_array_equal(pdropped.numpy(), np.asarray(dropped))


def test_station_waiting_times_match_reference(ref):
    _, queueing = ref
    rng = np.random.default_rng(6)
    t = np.sort(rng.random(300) * 20.0)
    s = rng.random(300) * 0.08
    want = queueing.station_waiting_times(t, s, 0.05, buffer_s=5.0)
    got = pq.station_waiting_times(t, s, 0.05, buffer_s=5.0, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------- #
# Options of later slices raise
# --------------------------------------------------------------------- #


class _Aimd:
    policy = "aimd"


@pytest.mark.parametrize("option", ["ground", "admission", "batching",
                                    "probes"])
def test_unported_constructor_options_raise(option):
    (_, _, _), (ptopo, pact, pplans) = _worlds(4)
    preq = pt.sample_requests(np.random.default_rng(8), rate_rps=1.0,
                              horizon_s=5.0, **REQ_KW)
    kw = {"ground": dict(ground=object()),
          "admission": dict(qcfg=pt.QueueConfig(admission=_Aimd())),
          "batching": dict(batching=object()),
          "probes": dict(probes=object())}[option]
    with pytest.raises(NotImplementedError, match="not ported"):
        pt.FleetSim(pplans, ptopo, pact, pc.MoEWorkload.llama_moe_3p5b(),
                    pc.ComputeConfig(), preq, np.random.default_rng(5),
                    device="cpu", **kw)


@pytest.mark.parametrize("call", ["run_replan", "run_many_replan",
                                  "run_many_targets", "station_batching"])
def test_unported_run_options_raise(ref, call):
    _, psim = _pair(ref, rate=1.0, horizon=10.0)
    masks = np.ones((1, psim.n_requests), dtype=bool)
    with pytest.raises(NotImplementedError, match="not ported"):
        if call == "run_replan":
            psim.run(replan=object())
        elif call == "run_many_replan":
            psim.run_many(replan=object())
        elif call == "run_many_targets":
            psim.run_many(masks, ttft_targets=np.array([5.0]))
        else:
            pq.station_waiting_times(np.array([0.0, 1.0]), 0.01, 0.05,
                                     batching=object(), device="cpu")
