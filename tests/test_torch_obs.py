"""The port's flight recorder against the reference's ``repro.obs``, on the
CPU.

The probe configuration, the ring's slot -> bin map and buffers, the
recorder, the exporter and the schema are host numpy: bitwise.  The
reference writes its probe ring from inside its scans; the port gathers
the final iteration's channels after its scan (``FleetSim._launch``).
``last_probes`` is held to the reference's bitwise on every channel
(backlog, util, drops, batch_b, qhat, win, admit and the gathered
waits), with one exception: under PID the ``admit`` channel is the PID
cell's state, which ``tests/test_torch_admission.py`` holds to rtol 1e-5
(XLA's CPU code rounds the PID cell differently from one IEEE operation
at a time).  The fleets are ``tests/test_torch_fleet.py``'s small world,
through its ``enable_x64`` shim.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro_torch.obs as pobs
from repro_torch.core import engine as pengine
from repro_torch.obs import probes as pprobes
from test_torch_admission import AIMD, PID
from test_torch_fleet import _pair, ref  # noqa: F401

CHANNELS = ("bins", "backlog_s", "util_s", "drops_s", "batch_b", "qhat_s",
            "win_s", "admit", "gw_wait_s", "ex_wait_s")


def _robs():
    import repro.obs as robs
    return robs


def _same_probes(got, want, pid=False):
    assert (got.dt_s, got.capacity, got.stride) == \
        (want.dt_s, want.capacity, want.stride)
    for name in CHANNELS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if pid and name == "admit":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0.0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------------------------------------------- #
# Host numpy: ProbeConfig, ring_bins, make_buffers
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("cap,stride,n_bins", [
    (64, None, 640), (64, None, 641), (64, None, 10), (8, 3, 10_000),
    (256, None, 40_966), (1, None, 7), (5, 2, 3)])
def test_probe_config_and_ring_match_reference(cap, stride, n_bins):
    robs = _robs()
    a = robs.ProbeConfig(capacity=cap, stride=stride).resolve(n_bins)
    b = pobs.ProbeConfig(capacity=cap, stride=stride).resolve(n_bins)
    assert a == b
    for x, y in zip(robs.ring_bins(n_bins, *a), pobs.ring_bins(n_bins, *b)):
        np.testing.assert_array_equal(y, x)
    # The ring a scan over every bin leaves behind.
    slots, bins = pobs.ring_bins(n_bins, *b)
    ring = {}
    for t in range(0, n_bins, b[1]):
        ring[(t // b[1]) % b[0]] = t
    assert sorted(ring.items(), key=lambda kv: kv[1]) == \
        list(zip(slots.tolist(), bins.tolist()))


@pytest.mark.parametrize("bad", [dict(capacity=0), dict(stride=0)])
def test_probe_config_refuses_what_the_reference_refuses(bad):
    robs = _robs()
    with pytest.raises(ValueError):
        robs.ProbeConfig(**bad)
    with pytest.raises(ValueError):
        pobs.ProbeConfig(**bad)


@pytest.mark.parametrize("admit,n_ch", [(None, 3), ((3, 5), 3), (None, 4),
                                        ((2, 1), 4)])
def test_make_buffers_match_reference(admit, n_ch):
    from repro.obs import probes as rprobes
    a = rprobes.make_buffers(16, 2, 11, admit, n_row_channels=n_ch)
    b = pprobes.make_buffers(16, 2, 11, admit, n_row_channels=n_ch)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(b[k], a[k])
    assert pprobes.ROW_CHANNELS == rprobes.ROW_CHANNELS
    assert (pprobes.BATCH_CHANNEL, pprobes.ADMISSION_CHANNELS) == \
        (rprobes.BATCH_CHANNEL, rprobes.ADMISSION_CHANNELS)


# --------------------------------------------------------------------- #
# last_probes against the reference's
# --------------------------------------------------------------------- #

CASES = {
    "plain": dict(rate=12.0, probes=dict(capacity=64)),
    "plain-1iter": dict(rate=12.0, probes=dict(capacity=64),
                        qkw=dict(iterations=1)),
    "wrap": dict(rate=12.0, probes=dict(capacity=16, stride=3)),
    "batching": dict(rate=12.0, batching=dict(b_max=8),
                     probes=dict(capacity=64)),
    "batching-1iter": dict(rate=12.0, batching=dict(b_max=8),
                           probes=dict(capacity=40),
                           qkw=dict(iterations=1)),
    "batching-window": dict(rate=12.0, batching=dict(b_max=4, window_s=0.1),
                            probes=dict(capacity=64, stride=1)),
    "aimd": dict(rate=6.0, ground=True, admission=AIMD,
                 probes=dict(capacity=64)),
    "aimd-1iter-batching": dict(rate=6.0, ground=True, admission=AIMD,
                                batching=dict(b_max=8),
                                probes=dict(capacity=32),
                                qkw=dict(iterations=1)),
    # A control bin every bin and the ring's tail: the last bin recorded
    # and a control bin, so its admit is the state its own update left.
    "aimd-every-bin": dict(rate=6.0, ground=True,
                           admission=dict(AIMD, interval_s=0.05),
                           probes=dict(capacity=12, stride=1)),
    "pid": dict(rate=6.0, ground=True, admission=PID,
                probes=dict(capacity=64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_last_probes_match_reference(ref, case):
    kw = CASES[case]
    sim, psim = _pair(ref, **kw)
    res, pres = sim.run(), psim.run()
    _same_probes(psim.last_probes, sim.last_probes, pid="pid" in case)
    rec = psim.last_probes
    assert rec.n_recorded == min(kw["probes"]["capacity"],
                                 -(-psim.n_bins // rec.stride))
    assert rec.backlog_s.shape == (rec.n_recorded, 1, psim.n_plans,
                                   psim.n_stations)
    assert (rec.batch_b is not None) == ("batching" in kw)
    assert rec.admission_on == ("admission" in kw)
    if case == "aimd-every-bin":
        assert rec.bins[-1] == psim.n_bins - 1
    elif "stride" not in kw["probes"]:          # the ring spans the run
        assert rec.backlog_s.any() and rec.util_s.any()
        if rec.admission_on:
            assert (rec.admit < 1.0).any() and rec.qhat_s.any()


def test_last_probes_run_many_match_reference(ref):
    """A sweep of F = 3 thinned masks, batching and AIMD admission with
    per-entry targets: every channel carries the F axis."""
    sim, psim = _pair(ref, rate=6.0, ground=True, admission=AIMD,
                      batching=dict(b_max=8), probes=dict(capacity=48))
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.array([0.4, 0.8, 1.0])[:, None]
    targets = np.array([2.0, 3.0, 6.0])
    sim.run_many(masks, ttft_targets=targets)
    psim.run_many(masks, ttft_targets=targets)
    _same_probes(psim.last_probes, sim.last_probes)
    assert psim.last_probes.admit.shape[1] == 3


@pytest.mark.parametrize("case", ["plain", "aimd-1iter-batching"])
def test_probes_off_run_is_unchanged(ref, case):
    """A probed run leaves nothing behind: the same simulator with its
    probes taken off, and a simulator built without them, give bitwise
    the probed run's results."""
    kw = dict(CASES[case])
    _, psim = _pair(ref, **kw)
    kw.pop("probes")
    _, plain = _pair(ref, **kw)
    before = plain.run()
    probed = psim.run()
    psim.probes = None
    after = psim.run()
    for a, b, c in zip(before.plans, probed.plans, after.plans):
        for name in ("served", "ttft_s", "e2e_s", "token_total_s",
                     "station_util"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name))
            np.testing.assert_array_equal(getattr(c, name),
                                          getattr(a, name))
    assert plain.last_probes is None


# --------------------------------------------------------------------- #
# Recorder and exporter against the reference's
# --------------------------------------------------------------------- #


def _same_log(got, want):
    assert (got.plan_names, got.plan, got.dt_s, got.n_bins, got.scenario,
            got.summary) == (want.plan_names, want.plan, want.dt_s,
                             want.n_bins, want.scenario, want.summary)
    assert len(got.requests) == len(want.requests)
    for a, b in zip(got.requests, want.requests):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray) or y is None:
                assert (x is None) == (y is None), f.name
                if y is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y or (np.isnan(x) and np.isnan(y)), f.name
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]


@pytest.mark.parametrize("case", ["aimd", "batching", "plain"])
def test_flight_log_and_trace_match_reference(ref, case, tmp_path):
    robs = _robs()
    sim, psim = _pair(ref, **CASES[case])
    res, pres = sim.run(), psim.run()
    for plan in (None, 0):
        log = robs.build_flight_log(sim, res, plan=plan, scenario=case)
        plog = pobs.build_flight_log(psim, pres, plan=plan, scenario=case)
        _same_log(plog, log)
    if case == "aimd":
        assert plog.events and all(e.kind == "aimd" for e in plog.events)
    if case == "batching":
        assert any(np.isfinite(r.batch_b) for r in plog.requests)
    trace = robs.chrome_trace(log, max_requests=50, max_sats=6)
    ptrace = pobs.write_trace(str(tmp_path / "t.json"), plog,
                              max_requests=50, max_sats=6)
    assert ptrace["metadata"].pop("generator") == "repro_torch.obs"
    assert trace["metadata"].pop("generator") == "repro.obs"
    assert ptrace == trace
    with open(tmp_path / "t.json") as f:
        on_disk = json.load(f)
    assert pobs.validate_trace(on_disk) == []
    for prefix, ph in (("prefill", "X"), ("sat", "C"), ("aimd", "i"),
                       ("", None)):
        assert pobs.count_events(on_disk, prefix, ph) == \
            robs.count_events(dict(trace, metadata={}), prefix, ph)
    assert pobs.count_events(on_disk, "prefill", "X") > 0


@pytest.mark.parametrize("case", ["aimd", "plain"])
def test_aimd_events_and_timeseries_match_reference(ref, case):
    robs = _robs()
    sim, psim = _pair(ref, **CASES[case])
    sim.run()
    psim.run()
    names = list(psim.batch.names)
    assert [dataclasses.astuple(e) for e in
            pobs.aimd_events(psim.last_probes, names)] == \
        [dataclasses.astuple(e) for e in
         robs.aimd_events(sim.last_probes, names)]
    for n_windows, plan in ((12, 0), (5, 1), (1000, 0)):
        assert pobs.summarize_timeseries(psim.last_probes, n_windows,
                                         plan) == \
            robs.summarize_timeseries(sim.last_probes, n_windows, plan)
    assert pobs.summarize_timeseries(None) == []
    assert pobs.aimd_events(None, names) == []


def test_validate_trace_reports_what_the_reference_reports():
    robs = _robs()
    bad = [None, [], {"traceEvents": 3}, {
        "traceEvents": [{"name": "x", "ph": "Q", "pid": 1, "ts": 0},
                        {"name": "x", "ph": "X", "pid": 1, "ts": -1},
                        {"name": "c", "ph": "C", "pid": 2, "ts": 0,
                         "args": {"v": True}},
                        {"name": "i", "ph": "i", "pid": 3, "ts": 0, "s": "z"},
                        "not an event"],
        "metadata": {"schema_version": 9}}]
    for obj in bad:
        assert pobs.validate_trace(obj) == robs.validate_trace(obj)
        assert pobs.validate_trace(obj)
    assert pobs.SCHEMA_VERSION == robs.SCHEMA_VERSION


@pytest.mark.parametrize("calibrated", [False, True])
def test_eq43_terms_and_breakdown_match_reference(ref, calibrated):
    from repro.core.engine import eq43_layer_terms
    robs = _robs()
    sim, psim = _pair(ref, rate=2.0, n_experts=8 if calibrated else 4,
                      calibrated=calibrated)
    for q in range(psim.n_plans):
        got = pengine.eq43_layer_terms(psim.batch, q, psim.slots,
                                       psim.draws, t_gateway=psim.t_gateway,
                                       t_expert=psim.t_expert)
        want = eq43_layer_terms(sim.batch, q, sim.slots,
                                np.asarray(sim.draws),
                                t_gateway=sim.t_gateway,
                                t_expert=sim.t_expert)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
        tokens = np.arange(0, psim.n_tokens, 3)
        a = pobs.eq43_breakdown(psim, q, tokens)
        b = robs.eq43_breakdown(sim, q, tokens)
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
        # The decomposition is the engine's zero-load layer latency.
        lay = psim.engine_results[q].layer_latency_s
        full = pobs.eq43_breakdown(psim, q, np.arange(psim.n_tokens))
        np.testing.assert_allclose(full["layer_s"], lay, rtol=1e-6,
                                   atol=1e-9, equal_nan=True)
