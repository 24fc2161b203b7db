"""The port's admission controller against the reference's, on the CPU.

Same seeded numpy inputs through ``repro.traffic.admission`` (imported
through the ``enable_x64`` shim of ``tests/test_torch_fleet.py``) and
``repro_torch.traffic.admission``.  The configuration, the control flags
and the attempt resolve are host numpy: bitwise.  ``admission_queue_scan``
runs in the port as ``backlog_scan`` + gathers + the ``admission_ctrl``
cell over control bins (plain versions here): wait and dropped are
bitwise the reference's scan, and so is the AIMD admit trace (its qhat
sums the layers in index order).  The PID trace is held to rtol 1e-5:
XLA's CPU code for the PID cell rounds differently from one IEEE
operation at a time (no combination of index-order or pairwise layer
sums and fused multiply-adds tried reproduces it), which moves admit by
up to ~1.4e-6 relative on these inputs.
The fleet runs under AIMD and PID admission are held to the reference's
``run()``/``run_many`` with identical shed, retries and served sets and
the reference's own fused-vs-legacy latency criterion (rtol 1e-5).
"""
import numpy as np
import pytest
import torch

import repro_torch.traffic as pt
from repro_torch.kernels import admission_ctrl as ctrl_mod
from repro_torch.kernels import admission_window as window_mod
from repro_torch.traffic import admission as padm
from test_torch_fleet import _assert_parity, _pair, ref  # noqa: F401

AIMD = dict(policy="aimd", ttft_target_s=3.0)
PID = dict(policy="pid", ttft_target_s=3.0, kd=0.02)


# --------------------------------------------------------------------- #
# AdmissionConfig, control_bin_flags, resolve_admission: host numpy
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("bad", [
    dict(policy="fifo"), dict(policy="pid", kp=0.0), dict(policy="pid", ki=-1.0),
    dict(policy="pid", kd=-0.1), dict(policy="pid", gain_scale=(1.0, 0.0)),
    dict(decrease=1.0), dict(decrease=0.0), dict(increase=0.0),
    dict(admit_min=0.0), dict(admit_min=1.5), dict(target_margin=0.0),
    dict(target_margin=1.1), dict(reference_quantile=-0.1),
    dict(reference_quantile=1.1), dict(max_retries=-1),
])
def test_admission_config_refuses_what_the_reference_refuses(ref, bad):
    traffic, _ = ref
    with pytest.raises(ValueError) as want:
        traffic.AdmissionConfig(**bad)
    with pytest.raises(ValueError) as got:
        pt.AdmissionConfig(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(policy="static", max_retries=0),
                                dict(policy="pid", gain_scale=(0.5, 2.0),
                                     max_retries=4)])
def test_admission_config_fields_match_reference(ref, kw):
    import dataclasses
    traffic, _ = ref
    a, b = traffic.AdmissionConfig(**kw), pt.AdmissionConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.n_attempts == b.n_attempts


@pytest.mark.parametrize("n_bins,dt,interval", [
    (1, 0.05, 0.5), (97, 0.05, 0.5), (100, 0.05, 0.5), (40, 0.05, 0.01),
    (333, 0.1, 0.35), (1000, 0.05, 2.0)])
def test_control_bin_flags_match_reference(ref, n_bins, dt, interval):
    traffic, _ = ref
    np.testing.assert_array_equal(
        pt.control_bin_flags(n_bins, dt, interval),
        traffic.control_bin_flags(n_bins, dt, interval))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_admission_matches_reference(ref, seed):
    traffic, _ = ref
    rng = np.random.default_rng(seed)
    p, g, t, a, r = 3, 4, 50, 3, 60
    admit = rng.random((p, g, t))
    admit[:, :, ::7] = 1.0
    args = (admit, rng.integers(0, t, (a, r)), rng.integers(0, g, (a, r)),
            rng.random((a, p, r)) < 0.8, rng.random((a, r)))
    for x, y in zip(traffic.resolve_admission(*args),
                    pt.resolve_admission(*args)):
        np.testing.assert_array_equal(y, x)


# --------------------------------------------------------------------- #
# admission_queue_scan: backlog_scan + gathers + the ctrl cell
# --------------------------------------------------------------------- #


def _scan_inputs(t, every, cap_kind, seed=0, p=3, s=11, n_layers=4,
                 n_exp=3, g=5):
    rng = np.random.default_rng(seed)
    work = (rng.gamma(0.5, 0.08, (p, s, t))
            * (rng.random((p, s, t)) < 0.4)).astype(np.float32)
    work[:, :2, t // 3:t // 2] *= 6.0                     # a surge
    cap = np.float32(10.0) if cap_kind == "scalar-loose" \
        else np.float32(0.4)                              # capped stations
    ctrl = (np.arange(t) + 1) % every == 0
    # Stations move with a (two-slot) schedule halfway through.
    gw0 = rng.integers(0, s, (p, n_layers))
    gw1 = rng.integers(0, s, (p, n_layers))
    ex0 = rng.integers(0, s, (p, n_layers * n_exp))
    ex1 = rng.integers(0, s, (p, n_layers * n_exp))
    half = np.arange(t) >= t // 2
    gw_idx = np.where(half[:, None, None], gw1, gw0).astype(np.int32)
    exp_idx = np.where(half[:, None, None], ex1, ex0).astype(np.int32)
    ttft0 = (rng.random((p, g)) * 1.5).astype(np.float32)
    tpot0 = (rng.random(p) * 0.3).astype(np.float32)
    return work, cap, ctrl, gw_idx, exp_idx, ttft0, tpot0


def _both_scans(ref, t, every, cap_kind, policy, tpot_target, gain=None,
                ttft_target=2.0):
    import jax.numpy as jnp
    traffic, _ = ref
    work, cap, ctrl, gw_idx, exp_idx, ttft0, tpot0 = _scan_inputs(
        t, every, cap_kind)
    p, g = ttft0.shape
    pid = pid_t = None
    if policy == "pid":
        gain = np.ones(p) if gain is None else np.asarray(gain)
        pid = dict(kp=jnp.asarray(0.4), ki=jnp.asarray(0.05),
                   kd=jnp.asarray(0.02), gain=jnp.asarray(gain))
        pid_t = dict(kp=0.4, ki=0.05, kd=0.02,
                     gain=torch.from_numpy(gain.astype(np.float32)))
    args = (0.05, ttft0, tpot0, ctrl, gw_idx, exp_idx,
            np.ones((p, g), np.float32), ttft_target, tpot_target, 0.1, 0.6,
            0.05)
    want = traffic.admission_queue_scan(
        jnp.asarray(work), jnp.asarray(cap), args[0],
        *(jnp.asarray(a) for a in args[1:7]), *args[7:], pid=pid)
    got = padm.admission_queue_scan(
        torch.from_numpy(work), float(cap), args[0],
        *(torch.from_numpy(np.asarray(a)) for a in args[1:7]), *args[7:],
        pid=pid_t)
    return [np.asarray(w) for w in want], [x.numpy() for x in got]


def _same_admit(got, want, policy):
    """AIMD: bitwise; PID: rtol 1e-5 (see the module docstring)."""
    if policy == "aimd":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("t,every,cap_kind,tpot_target", [
    (1000, 10, "scalar-loose", float("inf")),
    (997, 10, "capped", float("inf")),        # T not a multiple of every
    (400, 1, "capped", 0.9),                  # a control bin every bin
    (523, 7, "capped", 1.2),                  # TPOT term live
    (6, 10, "capped", 1.2),                   # no control bin at all
])
def test_admission_queue_scan_matches_the_reference(ref, policy, t, every,
                                                    cap_kind, tpot_target):
    (w_r, d_r, a_r), (w_p, d_p, a_p) = _both_scans(
        ref, t, every, cap_kind, policy, tpot_target)
    np.testing.assert_array_equal(w_p, w_r)
    np.testing.assert_array_equal(d_p, d_r)
    assert a_p.shape == a_r.shape == (3, 5, t)
    _same_admit(a_p, a_r, policy)
    if t >= 100 and (policy == "aimd" or cap_kind == "scalar-loose"):
        # the controller did act, both ways
        assert (a_r < 1.0).any() and (np.diff(a_r, axis=2) > 0).any()


def test_admission_queue_scan_pid_gain_scale(ref):
    (_, _, a_r), (_, _, a_p) = _both_scans(
        ref, 700, 10, "capped", "pid", float("inf"), gain=[0.5, 1.0, 3.0])
    _same_admit(a_p, a_r, "pid")


def test_admission_queue_scan_infinite_ttft_target(ref):
    """An infinite TTFT target drops the term: the AIMD cell only ever
    increases, the PID headroom comes from TPOT alone."""
    for policy in ("aimd", "pid"):
        (_, _, a_r), (_, _, a_p) = _both_scans(
            ref, 500, 10, "capped", policy, 1.0, ttft_target=float("inf"))
        _same_admit(a_p, a_r, policy)


def test_admission_queue_scan_refuses_batching():
    """Batching planes not shaped like the work plane are refused (the
    law itself: ``tests/test_torch_batching.py``)."""
    work, cap, ctrl, gw_idx, exp_idx, ttft0, tpot0 = _scan_inputs(40, 10,
                                                                  "capped")
    with pytest.raises(ValueError, match="shaped like work"):
        padm.admission_queue_scan(
            torch.from_numpy(work), float(cap), 0.05, ttft0, tpot0, ctrl,
            gw_idx, exp_idx, np.ones(ttft0.shape, np.float32), 2.0, 1.0,
            0.1, 0.6, 0.05, batching=dict(
                work_dec=torch.zeros(work.shape[:2] + (39,)),
                cnt_win=torch.zeros(work.shape), table=torch.ones(3),
                bcap=1.0))


def test_qhat_trace_chunks_do_not_change_it(monkeypatch):
    """qhat gathered a few bins at a time equals the one-chunk gather."""
    rng = np.random.default_rng(3)
    t, f, c, p, n_layers, n_exp = 97, 2, 13, 3, 4, 3
    wait = torch.from_numpy(rng.random((t, f, c)).astype(np.float32))
    work_last = torch.from_numpy(rng.random((f, c)).astype(np.float32))
    cap, dt = torch.tensor(0.9), torch.tensor(0.05)
    gw = torch.from_numpy(rng.integers(0, c, (5, p, n_layers)))
    ex = torch.from_numpy(rng.integers(0, c, (5, p, n_layers * n_exp)))
    bin_map = torch.from_numpy(rng.integers(0, 5, t))
    args = (wait, work_last, cap, dt, gw, ex, bin_map)
    whole = padm.qhat_trace(*args)
    monkeypatch.setattr(window_mod, "QHAT_CHUNK_ELEMS",
                        7 * f * p * n_layers * n_exp)
    np.testing.assert_array_equal(padm.qhat_trace(*args).numpy(),
                                  whole.numpy())
    # bin by bin in numpy: the backlog after bin t (one more step of the
    # recursion after the last), layers in index order
    f32 = np.float32
    last = np.maximum(np.minimum(wait.numpy()[-1] + work_last.numpy(),
                                 f32(0.9)) - f32(0.05), f32(0.0))
    after = np.concatenate([wait.numpy()[1:], last[None]])
    want = np.zeros((t, f, p), np.float32)
    for b in range(t):
        g_b, e_b = gw[bin_map[b]].numpy(), ex[bin_map[b]].numpy()
        for ll in range(n_layers):
            want[b] += after[b][:, g_b[:, ll]]
        e = after[b][:, e_b].reshape(f, p, n_layers, n_exp).max(-1)
        e_sum = e[..., 0]
        for ll in range(1, n_layers):
            e_sum = e_sum + e[..., ll]
        want[b] = want[b] + e_sum
    np.testing.assert_array_equal(whole.numpy(), want)


def _window_inputs(seed, t, f, every, last_ctrl, c=13, p=3, n_layers=4,
                   n_exp=3, n_slots=4):
    """A wait trace, the last bin's work, per-slot stations whose slot
    changes inside windows, and the control flags (a control bin at T - 1
    when ``last_ctrl``, else bins after the last control bin)."""
    rng = np.random.default_rng(seed)
    wait = (rng.gamma(0.5, 0.3, (t, f, c))
            * (rng.random((t, f, c)) < 0.6)).astype(np.float32)
    work_last = (rng.random((f, c)) * 2.0).astype(np.float32)
    gw = rng.integers(0, c, (n_slots, p, n_layers))
    ex = rng.integers(0, c, (n_slots, p, n_layers * n_exp))
    cuts = np.sort(rng.choice(np.arange(1, t), n_slots - 1, replace=False))
    bin_map = np.searchsorted(cuts, np.arange(t), side="right")
    ctrl = (np.arange(t) + 1) % every == 0
    ctrl[-1] = last_ctrl
    return wait, work_last, gw, ex, bin_map, ctrl


def _numpy_windows(wait, work_last, cap, dt, gw, ex, bin_map, ctrl):
    """Window maxima bin by bin in numpy: the backlog after bin t (one
    more step after the last), layers summed in index order."""
    f32 = np.float32
    t, f, _ = wait.shape
    p, n_layers = gw.shape[1:]
    last = np.maximum(np.minimum(wait[-1] + work_last, f32(cap)) - f32(dt),
                      f32(0.0))
    after = np.concatenate([wait[1:], last[None]])
    n_ctrl = int(ctrl.sum())
    win = np.zeros((n_ctrl, f, p), np.float32)
    k = 0
    for b in range(t):
        if k == n_ctrl:
            break
        g_b, e_b = gw[bin_map[b]], ex[bin_map[b]]
        q = after[b][:, g_b[:, 0]]
        for ll in range(1, n_layers):
            q = q + after[b][:, g_b[:, ll]]
        e = after[b][:, e_b].reshape(f, p, n_layers, -1).max(-1)
        e_sum = e[..., 0]
        for ll in range(1, n_layers):
            e_sum = e_sum + e[..., ll]
        win[k] = np.maximum(win[k], q + e_sum)
        k += int(ctrl[b])
    return win


@pytest.mark.parametrize("f", [1, 4])
@pytest.mark.parametrize("last_ctrl", [True, False],
                         ids=["ctrl-at-T-1", "bins-after-last-ctrl"])
@pytest.mark.parametrize("cap", [0.9, 10.0])
def test_admission_window_plain_matches_a_loop_over_bins(f, last_ctrl, cap):
    wait, work_last, gw, ex, bin_map, ctrl = _window_inputs(
        5, 157, f, 10, last_ctrl)
    seg, n_ctrl = window_mod.control_segments(torch.from_numpy(ctrl))
    assert n_ctrl == int(ctrl.sum())
    np.testing.assert_array_equal(seg.numpy(),
                                  np.cumsum(ctrl) - ctrl.astype(np.int64))
    got = window_mod.admission_window(
        torch.from_numpy(wait), torch.from_numpy(work_last), cap, 0.05,
        torch.from_numpy(gw), torch.from_numpy(ex),
        torch.from_numpy(bin_map), seg, n_ctrl)
    want = _numpy_windows(wait, work_last, cap, 0.05, gw, ex, bin_map, ctrl)
    assert got.shape == (n_ctrl, f, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain composition, qhat_trace then a scatter of maxima
    qhat = padm.qhat_trace(torch.from_numpy(wait),
                           torch.from_numpy(work_last), torch.tensor(cap),
                           torch.tensor(0.05), torch.from_numpy(gw),
                           torch.from_numpy(ex), torch.from_numpy(bin_map))
    full = torch.zeros((n_ctrl + 1, f, 3)).scatter_reduce(
        0, seg[:, None, None].expand_as(qhat), qhat, "amax")
    np.testing.assert_array_equal(got.numpy(), full[:n_ctrl].numpy())


def test_admission_window_refuses_mixed_shapes():
    wait, work_last, gw, ex, bin_map, ctrl = _window_inputs(0, 40, 1, 10,
                                                            True)
    seg, n_ctrl = window_mod.control_segments(torch.from_numpy(ctrl))
    args = [torch.from_numpy(a) for a in (wait, work_last, gw, ex, bin_map)]
    with pytest.raises(ValueError, match="shapes"):
        window_mod.admission_window(args[0], args[1][:, 1:], 1.0, 0.05,
                                    *args[2:], seg, n_ctrl)
    with pytest.raises(TypeError, match="float32"):
        window_mod.admission_window(args[0].double(), *args[1:2], 1.0, 0.05,
                                    *args[2:], seg, n_ctrl)


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_admission_queue_scan_slot_change_inside_a_window(ref, policy):
    """T = 203 with a control bin every 7: the last bin is a control bin
    (the backlog after it is one more step), and the stations switch at
    bin 101, inside the window that bin 104 closes."""
    (w_r, d_r, a_r), (w_p, d_p, a_p) = _both_scans(
        ref, 203, 7, "capped", policy, 1.2)
    np.testing.assert_array_equal(w_p, w_r)
    np.testing.assert_array_equal(d_p, d_r)
    _same_admit(a_p, a_r, policy)


def test_admission_ctrl_plain_refuses_mixed_shapes():
    win = torch.zeros(4, 2, 3)
    ok = dict(increase=0.1, decrease=0.6, admit_min=0.05)
    with pytest.raises(ValueError, match="shapes"):
        ctrl_mod.admission_ctrl(win, torch.zeros(3, 2), torch.zeros(3),
                                torch.ones(2, 3, 5), torch.ones(2),
                                torch.ones(2), **ok)
    with pytest.raises(TypeError, match="float32"):
        ctrl_mod.admission_ctrl(win.double(), torch.zeros(3, 2),
                                torch.zeros(3), torch.ones(2, 3, 2),
                                torch.ones(2), torch.ones(2), **ok)
    before = ctrl_mod.launches
    out = ctrl_mod.admission_ctrl(win, torch.zeros(3, 2), torch.zeros(3),
                                  torch.ones(2, 3, 2), torch.ones(2),
                                  torch.ones(2), **ok)
    assert out.shape == (4, 2, 3, 2) and ctrl_mod.launches == before


# --------------------------------------------------------------------- #
# FleetSim under admission against the reference
# --------------------------------------------------------------------- #


def _same_outcome(res_ref, res_port):
    """Identical shed, retries and served sets, latencies as the
    reference holds its fused path to its legacy one."""
    _assert_parity(res_ref, res_port)
    for pr, pp in zip(res_ref.plans, res_port.plans):
        np.testing.assert_array_equal(pp.shed, pr.shed)
        np.testing.assert_array_equal(pp.retries, pr.retries)


@pytest.mark.parametrize("adm", [AIMD, PID], ids=["aimd", "pid"])
def test_admission_tables_match_reference(ref, adm):
    sim, psim = _pair(ref, rate=6.0, ground=True, admission=adm)
    assert psim.admission_on and sim.admission_on
    assert (psim.n_bins, psim.n_rows, psim.n_gw_stations) == \
        (sim.n_bins, sim.n_rows, sim.n_gw_stations)
    for name in ("_att_station", "_att_extra", "_att_feasible", "_att_bin",
                 "_adm_u", "_adm_ttft0", "_adm_tpot0", "_adm_slot_of_bin",
                 "_adm_gw_idx", "_adm_exp_idx", "_active_rows", "_gw_rowc",
                 "_ex_rowc", "_f_rowc", "_f_pr"):
        np.testing.assert_array_equal(getattr(psim, name),
                                      getattr(sim, name), err_msg=name)
    slot = psim._adm_slot_of_bin
    np.testing.assert_array_equal(psim._adm_gw_rowc_slot[slot],
                                  sim._adm_gw_rowc)
    np.testing.assert_array_equal(psim._adm_exp_rowc_slot[slot],
                                  sim._adm_exp_rowc)
    assert psim._att_feasible[1:].any()           # alternative gateways


@pytest.mark.parametrize("adm", [AIMD, PID], ids=["aimd", "pid"])
def test_run_under_admission_matches_reference(ref, adm):
    sim, psim = _pair(ref, rate=6.0, ground=True, admission=adm)
    res, pres = sim.run(), psim.run()
    _same_outcome(res, pres)
    assert any(p.shed.any() for p in pres.plans)
    assert any(p.served.any() for p in pres.plans)
    _same_outcome(sim.run_legacy(), psim.run_legacy())


def test_retries_land_at_other_gateways(ref):
    """A tight target: some requests are admitted on a retry, through an
    alternative gateway, and pay its ingress."""
    sim, psim = _pair(ref, rate=8.0, ground=True,
                      admission=dict(AIMD, ttft_target_s=1.5))
    res, pres = sim.run(), psim.run()
    _same_outcome(res, pres)
    assert any(p.retries.any() for p in pres.plans)


def test_admission_without_ground_matches_reference(ref):
    """No ground segment: one logical gateway, retries at the origin
    after the backoff."""
    sim, psim = _pair(ref, rate=8.0, admission=dict(AIMD, ttft_target_s=2.0))
    assert psim.n_gw_stations == 1
    np.testing.assert_array_equal(psim._att_extra, sim._att_extra)
    _same_outcome(sim.run(), psim.run())


def test_fused_matches_host_path_under_admission(ref):
    _, psim = _pair(ref, rate=6.0, ground=True, admission=AIMD)
    _same_outcome(psim.run_legacy(), psim.run())


def test_run_many_target_sweep_matches_reference(ref):
    sim, psim = _pair(ref, rate=6.0, ground=True, admission=AIMD)
    base = psim.run(zero_load=True)
    _assert_parity(sim.run(zero_load=True), base)
    assert all(p.shed is None for p in base.plans)     # no controller
    ttft0 = max(p.quantile("ttft", 0.99) for p in base.plans)
    targets = np.array([1.5, 2.0, 3.0, 5.0]) * ttft0
    masks = np.ones((4, psim.n_requests), dtype=bool)
    many = sim.run_many(masks, ttft_targets=targets)
    pmany = psim.run_many(masks, ttft_targets=targets)
    for res, pres in zip(many, pmany):
        _same_outcome(res, pres)
    shed = [sum(int(p.shed.sum()) for p in r.plans) for r in pmany]
    assert shed[0] >= shed[-1] and shed[0] > 0
    # one entry of the sweep is the run() at that target
    sim1, psim1 = _pair(ref, rate=6.0, ground=True,
                        admission=dict(AIMD, ttft_target_s=targets[2]))
    _same_outcome(pmany[2], psim1.run())


def test_run_many_tpot_sweep_matches_reference(ref):
    sim, psim = _pair(ref, rate=6.0, ground=True, admission=PID)
    masks = np.ones((3, psim.n_requests), dtype=bool)
    masks[1, ::3] = False
    tp = np.array([0.5, 2.0, np.inf])
    for res, pres in zip(sim.run_many(masks, tpot_targets=tp),
                         psim.run_many(masks, tpot_targets=tp)):
        _same_outcome(res, pres)


def test_run_many_refusals_match_reference(ref):
    sim, psim = _pair(ref, rate=2.0, horizon=10.0)
    masks = np.ones((1, psim.n_requests), dtype=bool)
    for s in (sim, psim):
        with pytest.raises(ValueError, match="AIMD admission"):
            s.run_many(masks, ttft_targets=np.array([5.0]))
        with pytest.raises(ValueError, match="replan"):
            s.run_many(masks, cadences=[1])
    _, psim = _pair(ref, rate=2.0, horizon=10.0, admission=AIMD)
    with pytest.raises(ValueError, match="one per activity mask"):
        psim.run_many(masks, ttft_targets=np.array([5.0, 6.0]))


def test_gain_scale_length_must_match_the_plans(ref):
    import repro_torch.core as pc
    from test_torch_fleet import REQ_KW, _worlds
    traffic, _ = ref
    adm = dict(PID, gain_scale=(1.0, 2.0, 3.0))
    (topo, act, plans), (ptopo, pact, pplans) = _worlds(4)
    from repro.core import ComputeConfig, MoEWorkload
    req = traffic.sample_requests(np.random.default_rng(8), rate_rps=1.0,
                                  horizon_s=5.0, **REQ_KW)
    with pytest.raises(ValueError) as want:
        traffic.FleetSim(plans, topo, act, MoEWorkload.llama_moe_3p5b(),
                         ComputeConfig(), req, np.random.default_rng(5),
                         qcfg=traffic.QueueConfig(
                             admission=traffic.AdmissionConfig(**adm)))
    with pytest.raises(ValueError) as got:
        pt.FleetSim(pplans, ptopo, pact, pc.MoEWorkload.llama_moe_3p5b(),
                    pc.ComputeConfig(), pt.sample_requests(
                        np.random.default_rng(8), rate_rps=1.0,
                        horizon_s=5.0, **REQ_KW),
                    np.random.default_rng(5), device="cpu",
                    qcfg=pt.QueueConfig(admission=pt.AdmissionConfig(**adm)))
    assert str(got.value) == str(want.value) == \
        "gain_scale has 3 entries for 2 plans"


def test_pid_gain_scale_run_matches_reference(ref):
    sim, psim = _pair(ref, rate=6.0, ground=True,
                      admission=dict(PID, gain_scale=(0.5, 2.0)))
    _same_outcome(sim.run(), psim.run())


def test_static_policy_keeps_the_kv_cap(ref):
    sim, psim = _pair(ref, rate=8.0, ground=True,
                      admission=dict(policy="static"), qkw=dict(kv_slots=3))
    assert not psim.admission_on
    res, pres = sim.run(), psim.run()
    _assert_parity(res, pres)
    assert all(p.shed is None for p in pres.plans)
