"""The port's planet-scale federation (``repro_torch.traffic.federation``)
against the reference's, on the CPU.

The guards of the reference's ``tests/test_federation.py`` about the
federation, each also held against the reference on the same seeded
worlds (K = 3 members of 8 x 12 satellites, 10 slots, 4 MoE layers of 4
experts, top-2, the 8 default gateways, AIMD admission): identical
served, shed, retry, hop and assignment sets and round counts, TTFT and
E2E to rtol 1e-5, goodput to 1e-9.  Within the port, overflow-off members
are bitwise their own ``FleetSim.run``.  The reference's one-compile-trace
pin becomes one ``_fleet_fixed_point`` call per overflow round, counted
here by a test-only monkeypatch.  The kernels' premises are checked on
the lane-stacked, padded tables through their plain versions.  The
reference's ``repro.traffic`` comes through the ``ref`` fixture of
``tests/test_torch_fleet.py`` (the ``enable_x64`` shim).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as pc
import repro_torch.traffic as pt
from repro_torch.traffic import admission as padm
from repro_torch.traffic import federation as pfed
from repro_torch.traffic import queueing as pq
from test_torch_fleet import _assert_parity, ref  # noqa: F401


def _factory(c, t, seed, req, qcfg, n_plans=1):
    """One member world (the reference test's): own topology draw, ground
    visibility and plans."""
    cfg = c.ConstellationConfig.scaled(8, 12, n_slots=10, survival_prob=1.0)
    kw = {"device": "cpu"} if t is pt else {}

    def build(min_bins=0):
        con = c.Constellation(cfg)
        topo = c.sample_topology(con, c.LinkConfig(),
                                 np.random.default_rng(seed))
        act = c.ActivationModel.zipf(4, 4, 2, seed=1)
        ground = t.build_ground_segment(con, c.LinkConfig(),
                                        min_elevation_deg=10.0)
        plans = [c.spacemoe_plan(con, topo, act)]
        if n_plans > 1:
            plans.append(c.rand_intra_cg_plan(cfg, 4, 4,
                                              np.random.default_rng(seed)))
        return t.FleetSim(plans, topo, act, c.MoEWorkload.llama_moe_3p5b(),
                          c.ComputeConfig(), req, np.random.default_rng(5),
                          qcfg=qcfg, ground=ground, min_bins=min_bins, **kw)
    return build


def _requests(t, horizon_s, rate_rps, seed=8):
    return t.sample_requests(np.random.default_rng(seed), rate_rps=rate_rps,
                             horizon_s=horizon_s, n_stations=8,
                             prompt_median=4, prompt_max=16, decode_mean=4,
                             decode_max=8)


def _federation(c, t, horizon_s=40.0, rate_rps=4.0, ttft_target=8.0,
                seeds=(0, 1, 2), n_plans=(1, 1, 1), adm=None, **fed_kwargs):
    """The reference test's ``_federation`` world in the package of core
    ``c`` and traffic ``t``."""
    req = _requests(t, horizon_s, rate_rps)
    acfg = t.AdmissionConfig(**dict(dict(ttft_target_s=ttft_target),
                                    **(adm or {})))
    qcfg = t.QueueConfig(dt_s=0.05, tail_s=40.0, admission=acfg)
    return t.build_federation(
        [_factory(c, t, s, req, qcfg, n_plans=p)
         for s, p in zip(seeds, n_plans)], **fed_kwargs), req


def _pair(ref, **kw):
    """(reference federation, port federation, the port's trace)."""
    import repro.core as rc
    traffic, _ = ref
    fed, _ = _federation(rc, traffic, **kw)
    pfed_, req = _federation(pc, pt, **kw)
    return fed, pfed_, req


def _same_result(a, b):
    """The reference's FederationResult against the port's."""
    assert a.n_rounds == b.n_rounds
    for name in ("assigned", "hops", "offered"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    fa, fb = a.federated, b.federated
    for name in ("active", "served", "shed", "retries"):
        np.testing.assert_array_equal(getattr(fb, name), getattr(fa, name),
                                      err_msg=name)
    for name in ("ttft_s", "e2e_s", "tpot_s"):
        np.testing.assert_allclose(getattr(fb, name), getattr(fa, name),
                                   rtol=1e-5, equal_nan=True, err_msg=name)
    assert np.isclose(fb.goodput_tok_s, fa.goodput_tok_s, rtol=1e-9,
                      atol=0.0)
    for ma, mb in zip(a.members, b.members, strict=True):
        _assert_parity(ma, mb)
        for pa, pb in zip(ma.plans, mb.plans):
            np.testing.assert_array_equal(pb.shed, pa.shed)
            np.testing.assert_array_equal(pb.retries, pa.retries)


class _Counter:
    """Counts ``_fleet_fixed_point`` calls of the port's federation."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = pfed._fleet_fixed_point

        def counted(*args, **kw):
            self.calls += 1
            return real(*args, **kw)
        monkeypatch.setattr(pfed, "_fleet_fixed_point", counted)


# --------------------------------------------------------------------- #
# One fixed point a round for the whole federation
# --------------------------------------------------------------------- #


def test_federation_nested_sweep_is_one_fixed_point_a_round(ref,
                                                            monkeypatch):
    """K = 3 members under a 2-point nested sweep (6 lanes): each overflow
    round is one fixed-point call over every lane, a rerun gives the same
    results, and both match the reference's."""
    fed, pfed_, req = _pair(ref, horizon_s=37.0, rate_rps=3.7)
    masks = np.stack([
        np.ones(req.n_requests, dtype=bool),
        np.random.default_rng(0).random(req.n_requests) < 0.5])
    count = _Counter(monkeypatch)
    got = pfed_.run_many(masks)
    assert len(got) == 2
    assert count.calls == got[0].n_rounds == got[1].n_rounds >= 1
    for a, b in zip(fed.run_many(masks), got):
        _same_result(a, b)
    count.calls = 0
    again = pfed_.run_many(masks)
    assert count.calls == again[0].n_rounds
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a.federated.ttft_s,
                                      b.federated.ttft_s)


# --------------------------------------------------------------------- #
# Bitwise parity with standalone members (overflow off)
# --------------------------------------------------------------------- #


def test_overflow_off_members_bitwise_match_standalone_runs(ref):
    """With overflow disabled, every member's per-plan outcome — across
    both sweep entries and across members of *different* plan counts
    (the edge-repeat plan padding) — is bitwise identical to running that
    FleetSim alone on its home slice of the trace, and matches the
    reference's federation."""
    fed, pfed_, req = _pair(ref, horizon_s=41.0, n_plans=(2, 1, 1))
    assert pfed_._p_max == 2                 # padding genuinely exercised
    masks = np.stack([
        np.ones(req.n_requests, dtype=bool),
        np.random.default_rng(1).random(req.n_requests) < 0.6])
    results = pfed_.run_many(masks, overflow=False)
    for s in range(2):
        for k, sim in enumerate(pfed_.sims):
            alone = sim.run(masks[s] & (pfed_.home == k))
            for pf, pa in zip(results[s].members[k].plans, alone.plans,
                              strict=True):
                for name in ("served", "shed", "retries", "ttft_s",
                             "e2e_s", "tpot_s", "station_util",
                             "token_total_s"):
                    np.testing.assert_array_equal(getattr(pf, name),
                                                  getattr(pa, name),
                                                  err_msg=name)
    for a, b in zip(fed.run_many(masks, overflow=False), results):
        _same_result(a, b)


# --------------------------------------------------------------------- #
# Overflow routing: monotone fixed point + latency billing
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_overflow_reroutes_shed_requests_and_converges(ref, policy):
    """Under a shedding load overflow moves rejected requests to the
    next-ranked member: the pooled shed set shrinks against independent
    operation, the loop converges within K rounds, offered masks stay
    disjoint, hops respect the K - 1 budget and only count forward moves
    along each request's ranking; the reference's results, under the
    AIMD and the PID law."""
    fed, pfed_, _ = _pair(ref, horizon_s=43.0, rate_rps=4.3,
                          adm=dict(policy=policy))
    off, on = pfed_.run(overflow=False), pfed_.run(overflow=True)
    _same_result(fed.run(overflow=False), off)
    _same_result(fed.run(overflow=True), on)
    assert off.federated.shed.sum() > 0            # load genuinely sheds
    assert on.federated.shed.sum() < off.federated.shed.sum()
    assert (on.hops > 0).any()
    assert on.n_rounds <= pfed_.n_members
    assert (on.hops <= pfed_.n_members - 1).all()
    assert (on.offered.sum(axis=0) <= 1).all()
    moved = (on.hops > 0) & on.federated.served
    assert moved.any()
    for r in np.flatnonzero(moved)[:50]:
        assert list(pfed_.ranking[r]).index(on.assigned[r]) >= on.hops[r]
    assert np.isfinite(on.federated.ttft_s[moved]).all()
    assert np.isfinite(on.federated.e2e_s[moved]).all()


def test_overflow_forward_latency_bills_ttft_not_tpot(ref):
    """Raising the forwarding delay shifts a rerouted request's TTFT and
    E2E by exactly hops * delta and leaves TPOT bitwise unchanged; the
    reference's results at both delays."""
    fed, pfed_, _ = _pair(ref, horizon_s=47.0, rate_rps=4.1)
    lo = pfed_.run()
    assert pfed_.forward_delay_s == fed.forward_delay_s
    hi_cfg = pt.FederationConfig(forward_delay_s=pfed_.forward_delay_s + 2.5)
    hi = pt.FederationSim(pfed_.sims, hi_cfg, home=None).run()
    traffic, _ = ref
    ref_hi = traffic.FederationSim(fed.sims, traffic.FederationConfig(
        forward_delay_s=fed.forward_delay_s + 2.5), home=None).run()
    _same_result(fed.run(), lo)
    _same_result(ref_hi, hi)
    np.testing.assert_array_equal(lo.federated.served, hi.federated.served)
    np.testing.assert_array_equal(lo.hops, hi.hops)
    served = lo.federated.served
    shift = lo.hops * 2.5
    np.testing.assert_allclose(hi.federated.ttft_s[served],
                               lo.federated.ttft_s[served] + shift[served],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(hi.federated.e2e_s[served],
                               lo.federated.e2e_s[served] + shift[served],
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(lo.federated.tpot_s, hi.federated.tpot_s)
    assert (lo.hops > 0).any()


def test_home_override_concentrates_load(ref):
    """An explicit home vector pins every feasible request on one member;
    infeasible homes fall back to the cost ranking; the reference's homes
    and results."""
    traffic, _ = ref
    fed, pfed_, req = _pair(ref, horizon_s=38.0)
    home = np.zeros(req.n_requests, dtype=np.int64)
    hot = pt.FederationSim(pfed_.sims, pt.FederationConfig(), home=home)
    ref_hot = traffic.FederationSim(fed.sims, traffic.FederationConfig(),
                                    home=home)
    np.testing.assert_array_equal(hot.home, ref_hot.home)
    np.testing.assert_array_equal(hot.ranking, ref_hot.ranking)
    feasible0 = hot.feasible[0]
    assert (hot.home[feasible0] == 0).all()
    res = hot.run(overflow=False)
    _same_result(ref_hot.run(overflow=False), res)
    np.testing.assert_array_equal(res.offered[0], feasible0)
    assert not res.offered[1:].any() or (
        hot.home[res.offered[1:].any(axis=0)] != 0).all()
    with pytest.raises(ValueError, match="home must be"):
        pt.FederationSim(pfed_.sims, home=home[:-1])
    with pytest.raises(ValueError, match="out of range"):
        pt.FederationSim(pfed_.sims, home=home + 3)


# --------------------------------------------------------------------- #
# Construction: shared bin grid + member validation
# --------------------------------------------------------------------- #


def test_build_federation_equalizes_bin_grids(ref):
    """Members whose natural horizons disagree are rebuilt on the
    federation-wide bin grid, the reference's; direct construction with
    mismatched grids refuses."""
    import repro.core as rc
    traffic, _ = ref
    grids = []
    for c, t in ((rc, traffic), (pc, pt)):
        req = _requests(t, 40.0, 2.0)
        q_short = t.QueueConfig(dt_s=0.05, tail_s=20.0,
                                admission=t.AdmissionConfig(ttft_target_s=10.0))
        q_long = t.QueueConfig(dt_s=0.05, tail_s=60.0,
                               admission=t.AdmissionConfig(ttft_target_s=10.0))
        fed = t.build_federation([_factory(c, t, 0, req, q_short),
                                  _factory(c, t, 1, req, q_long)])
        grids.append([s.n_bins for s in fed.sims])
    assert grids[0] == grids[1] and grids[1][0] == grids[1][1]
    with pytest.raises(ValueError, match="time bins"):
        pt.FederationSim([_factory(pc, pt, 0, req, q_short)(),
                          _factory(pc, pt, 1, req, q_long)()])


def test_validation_rejects_incompatible_members(ref):
    """The reference's refusals, each with the reference's exception."""
    import repro.core as rc
    traffic, _ = ref
    for c, t in ((rc, traffic), (pc, pt)):
        req = _requests(t, 35.0, 2.0)
        qcfg = t.QueueConfig(dt_s=0.05, tail_s=40.0,
                             admission=t.AdmissionConfig(ttft_target_s=10.0))
        base = _factory(c, t, 0, req, qcfg)()
        with pytest.raises(ValueError, match="request trace"):
            t.FederationSim([base, _factory(c, t, 1, _requests(t, 35.0, 2.0,
                                                               seed=9),
                                            qcfg)()])
        q_off = dataclasses.replace(qcfg, admission=None)
        with pytest.raises(ValueError, match="admission"):
            t.FederationSim([base, _factory(c, t, 1, req, q_off)()])
        with pytest.raises(ValueError, match="overflow"):
            t.FederationSim([_factory(c, t, 0, req, q_off)(),
                             _factory(c, t, 1, req, q_off)()],
                            t.FederationConfig(overflow=True))
        q_law = dataclasses.replace(qcfg, admission=t.AdmissionConfig(
            ttft_target_s=10.0, decrease=0.3))
        with pytest.raises(ValueError, match="admission law"):
            t.FederationSim([base, _factory(c, t, 1, req, q_law)()])
        q_tgt = dataclasses.replace(qcfg, admission=t.AdmissionConfig(
            ttft_target_s=25.0))
        t.FederationSim([base, _factory(c, t, 1, req, q_tgt)()])
        with pytest.raises(ValueError, match="at least one member"):
            t.FederationSim([])


# --------------------------------------------------------------------- #
# The port's lane tables
# --------------------------------------------------------------------- #


def test_members_with_other_slot_maps_match_reference(ref):
    """Members whose topology slots change at other times (10 s and 15 s
    slots): the federation's station map over the distinct slot tuples
    gives each member, at every bin, its own map at its own slot; the
    reference (per-bin maps) gets the same results, per-member targets
    differing too."""
    import repro.core as rc
    traffic, _ = ref
    feds = []
    for c, t in ((rc, traffic), (pc, pt)):
        req = _requests(t, 40.0, 4.2)
        qs = [t.QueueConfig(dt_s=0.05, tail_s=40.0, slot_period_s=period,
                            admission=t.AdmissionConfig(ttft_target_s=tt))
              for period, tt in ((10.0, 8.0), (15.0, 6.0))]
        feds.append(t.build_federation(
            [_factory(c, t, s, req, q) for s, q in zip((0, 1), qs)]))
    fed, pfed_ = feds
    assert not np.array_equal(pfed_.sims[0]._adm_slot_of_bin,
                              pfed_.sims[1]._adm_slot_of_bin)
    st = pfed_._stacked_consts()
    for k, sim in enumerate(pfed_.sims):
        np.testing.assert_array_equal(
            st["gw_rows_slot"][st["slot_of_bin"], k],
            sim._adm_gw_rowc_slot[sim._adm_slot_of_bin])
        np.testing.assert_array_equal(
            st["exp_rows_slot"][st["slot_of_bin"], k],
            sim._adm_exp_rowc_slot[sim._adm_slot_of_bin])
    assert st["gw_rows_slot"].shape[0] < pfed_.n_bins
    for route in (False, True):
        _same_result(fed.run(overflow=route), pfed_.run(overflow=route))


def test_resolve_attempts_per_lane_matches_a_loop_over_lanes():
    """The (F, A, R) attempt tables resolve each lane as the shared
    (A, R) branch resolves that lane alone."""
    rng = np.random.default_rng(3)
    T, F, P, G, A, R = 50, 4, 2, 3, 3, 40
    floor = torch.from_numpy(rng.random((T, F, P, G)).astype(np.float32))
    q = dict(att_bin=torch.from_numpy(rng.integers(0, T, (F, A, R))),
             att_station=torch.from_numpy(rng.integers(0, G, (F, A, R))),
             adm_u=torch.from_numpy(rng.random((F, A, R))),
             att_feasible=torch.from_numpy(rng.random((F, P, A, R)) < 0.8),
             att_extra=torch.from_numpy(rng.random((F, P, A, R))))
    shed, retries, extra = pq._resolve_attempts(q, floor, per_entry=True)
    for f in range(F):
        qf = {k: v[f] for k, v in q.items()}
        s1, r1, e1 = pq._resolve_attempts(qf, floor[:, f:f + 1])
        torch.testing.assert_close(shed[f], s1[0], rtol=0, atol=0)
        torch.testing.assert_close(retries[f], r1[0], rtol=0, atol=0)
        torch.testing.assert_close(extra[f], e1[0], rtol=0, atol=0)


def test_kernel_premises_hold_on_padded_lanes(ref, monkeypatch):
    """The tables a federation with padded plans (2, 1, 1) gives the four
    fleet kernels, through their plain versions: ``deposit``'s table
    grouped by row (``fprow`` nondecreasing, ``row_ptr`` its grouping,
    zero-valued padding, bins in range), padded rows empty;
    ``backlog_scan``'s work finite and non-negative, zero on padded rows;
    ``admission_window``'s per-lane station maps inside each lane's rows;
    ``admission_ctrl``'s constants inside ``AdmissionConfig``'s ranges."""
    _, pfed_, req = _pair(ref, horizon_s=41.0, n_plans=(2, 1, 1))
    seen = {k: [] for k in ("deposit", "scan", "window", "ctrl")}
    real = (pq.deposit, pq.backlog_scan, padm.admission_window,
            padm.admission_ctrl)

    def dep(rows, cols, vals, n_rows, n_cols, row_ptr):
        seen["deposit"].append((rows, cols, vals, n_rows, n_cols, row_ptr))
        return real[0](rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)

    def scan(work, cap, dt):
        seen["scan"].append(work)
        return real[1](work, cap, dt)

    def window(*args):
        seen["window"].append(args)
        return real[2](*args)

    def ctrl(win, *args, **kw):
        seen["ctrl"].append((win, args, kw))
        return real[3](win, *args, **kw)
    monkeypatch.setattr(pq, "deposit", dep)
    monkeypatch.setattr(pq, "backlog_scan", scan)
    monkeypatch.setattr(padm, "admission_window", window)
    monkeypatch.setattr(padm, "admission_ctrl", ctrl)
    masks = np.stack([np.ones(req.n_requests, dtype=bool),
                      np.random.default_rng(1).random(req.n_requests) < 0.6])
    res = pfed_.run_many(masks, overflow=True)
    n_it = pfed_.sims[0].qcfg.iterations
    rounds = res[0].n_rounds
    assert [len(v) for v in seen.values()] == \
        [rounds * (n_it - 1), rounds * n_it, rounds * n_it, rounds * n_it]
    K, SR, T = pfed_.n_members, pfed_._sr_max, pfed_.n_bins
    F = 2 * K
    # Rows past a member's own rows, in every lane: zero-extended padding.
    pad_rows = np.concatenate([f * SR + np.arange(pfed_.sims[f % K].n_rows,
                                                  SR) for f in range(F)])
    assert pad_rows.size                          # padding genuinely there
    for rows, cols, vals, n_rows, n_cols, row_ptr in seen["deposit"]:
        n = int(row_ptr[-1])
        assert (n_rows, n_cols) == (F * SR, T)
        assert bool((rows[1:n] >= rows[:n - 1]).all())
        counts = torch.bincount(rows[:n], minlength=n_rows)
        torch.testing.assert_close(row_ptr[1:] - row_ptr[:-1], counts,
                                   rtol=0, atol=0)
        assert bool((vals[n:] == 0).all())
        assert bool(((cols >= 0) & (cols < T)).all())
        assert not bool(counts[pad_rows].any())
        assert bool(torch.isfinite(vals).all())
    for work in seen["scan"]:
        assert work.shape == (T, F * SR)
        assert bool(torch.isfinite(work).all()) and bool((work >= 0).all())
        assert not bool(work[:, pad_rows].any())
    for args in seen["window"]:
        wait, gw, ex, bin_map = args[0], args[4], args[5], args[6]
        assert gw.dim() == 4 and gw.shape[1] == F       # per-lane maps
        for f in range(F):
            n_rows_f = pfed_.sims[f % K].n_rows
            assert int(gw[:, f].max()) < n_rows_f
            assert int(ex[:, f].max()) < n_rows_f
        assert int(bin_map.max()) < gw.shape[0]
        assert bool(torch.isfinite(wait).all()) and bool((wait >= 0).all())
    acfg = pfed_.sims[0].qcfg.admission
    for win, args, kw in seen["ctrl"]:
        assert kw["increase"] == acfg.increase > 0.0
        assert 0.0 < kw["decrease"] == acfg.decrease < 1.0
        assert 0.0 < kw["admit_min"] == acfg.admit_min <= 1.0
        assert args[0].shape[:2] == (F, pfed_._p_max)   # per-lane anchors
        assert bool((win[torch.isfinite(win)] >= 0).all())


def test_make_federation_matches_reference(ref):
    """``scenarios.make_federation`` over a named scenario, one shared
    and K listed constellation configs, against the reference's."""
    import repro.core as rc
    traffic, _ = ref
    out = []
    for c, t in ((rc, traffic), (pc, pt)):
        cfg = c.ConstellationConfig.scaled(8, 12, n_slots=10,
                                           survival_prob=1.0)
        sc = dataclasses.replace(t.get_scenario("regional-hotspot-controlled"),
                                 horizon_s=40.0, tail_s=30.0,
                                 admission=t.AdmissionConfig(ttft_target_s=6.0))
        kw = {"device": "cpu"} if t is pt else {}
        fed = t.make_federation(sc, 2, cfg, c.MoEWorkload.llama_moe_3p5b(),
                                c.ComputeConfig(), np.random.default_rng(6),
                                rate_scale=10.0, **kw)
        out.append((fed, fed.run()))
        with pytest.raises(ValueError, match="constellation configs"):
            t.make_federation("smoke", 2, [cfg], c.MoEWorkload.llama_moe_3p5b(),
                              c.ComputeConfig(), np.random.default_rng(6),
                              **kw)
    (fed, a), (pfed_, b) = out
    assert [s.n_bins for s in pfed_.sims] == [s.n_bins for s in fed.sims]
    assert all(s.device.type == "cpu" for s in pfed_.sims)
    _same_result(a, b)
    assert b.federated.served.any()


@pytest.mark.parametrize("case", ["batching", "batching_no_admission",
                                  "schedules"])
def test_federation_options_match_reference(ref, case):
    """The member options the lanes carry through: continuous batching
    (the iteration-1 law on the host, the decode planes deposited a lane
    at a time), no admission (overflow off) and plan schedules whose
    switches lay migration background load on each lane's rows."""
    import repro.core as rc
    traffic, _ = ref
    adm = case != "batching_no_admission"
    out = []
    for c, t in ((rc, traffic), (pc, pt)):
        req = _requests(t, 40.0, 4.0)
        qkw = dict(dt_s=0.05, tail_s=40.0, admission=t.AdmissionConfig(
            ttft_target_s=8.0) if adm else None)
        if case == "schedules":
            qkw["slot_period_s"] = 10.0
        qcfg = t.QueueConfig(**qkw)
        cfg = c.ConstellationConfig.scaled(8, 12, n_slots=10,
                                           survival_prob=1.0)
        kw = {"device": "cpu"} if t is pt else {}
        if case.startswith("batching"):
            kw["batching"] = t.BatchingConfig(b_max=4)

        def factory(seed, c=c, t=t, req=req, qcfg=qcfg, cfg=cfg, kw=kw):
            def build(min_bins=0):
                con = c.Constellation(cfg)
                topo = c.sample_topology(con, c.LinkConfig(),
                                         np.random.default_rng(seed))
                act = c.ActivationModel.zipf(4, 4, 2, seed=1)
                plans = [c.spacemoe_plan(con, topo, act),
                         c.rand_intra_cg_plan(cfg, 4, 4,
                                              np.random.default_rng(seed))]
                if case == "schedules":
                    plans = [c.PlanSchedule(plans=plans,
                                            slot_plan=np.array([0, 1] * 5),
                                            name="flip")]
                return t.FleetSim(
                    plans, topo, act, c.MoEWorkload.llama_moe_3p5b(),
                    c.ComputeConfig(), req, np.random.default_rng(5),
                    qcfg=qcfg, ground=t.build_ground_segment(
                        con, c.LinkConfig(), min_elevation_deg=10.0),
                    min_bins=min_bins, **kw)
            return build
        fed = t.build_federation([factory(s) for s in (0, 1)],
                                 t.FederationConfig(overflow=adm))
        out.append(fed.run())
    a, b = out
    assert a.n_rounds == b.n_rounds
    np.testing.assert_array_equal(b.hops, a.hops)
    np.testing.assert_array_equal(b.federated.served, a.federated.served)
    np.testing.assert_allclose(b.federated.ttft_s, a.federated.ttft_s,
                               rtol=1e-5, equal_nan=True)
    for ma, mb in zip(a.members, b.members, strict=True):
        _assert_parity(ma, mb)
    assert b.federated.served.any()
    if case == "schedules":
        assert b.federated.migration_bytes == a.federated.migration_bytes > 0
