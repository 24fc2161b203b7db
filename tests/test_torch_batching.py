"""The port's continuous decode batching against the reference's, on the CPU.

Same seeded numpy inputs through ``repro.traffic.batching`` and the
fleet (imported through the ``enable_x64`` shim of
``tests/test_torch_fleet.py``) and through ``repro_torch.traffic``.

* ``BatchingConfig``, ``windowed_counts``, ``batch_speedup_at`` and
  ``effective_work_np`` are host numpy: bitwise.
* The tensor law ``batched_effective_work`` runs one IEEE operation at a
  time in the reference's order: bitwise the reference's (float64, x64)
  and ``effective_work_np`` on the same windowed counts.
  ``windowed_counts_torch`` is a ``torch.cumsum`` difference: on the CPU
  bitwise ``np.cumsum``'s, while the reference's ``jnp.cumsum`` sums in
  another order on XLA's CPU, so a window wider than one bin is held to
  the reference within ``2 * T * eps * max|cumsum|`` (the error bound of
  two sums of T terms).
* ``FleetSim(batching=)``: ``run``, ``run_many`` and ``run_legacy`` at a
  window of one bin give bitwise the reference's latencies (arrays equal,
  NaNs included); over a wider window, and for the host path under
  admission (whose law the reference evaluates in float32 inside its
  jitted scan), they are held to the reference's own fused-vs-legacy
  criterion (identical served, shed and retry sets, goodput to 1e-9,
  latencies to rtol 1e-5).
* ``b_max=1`` is bitwise ``batching=None``; under hypothesis the
  effective work of a deposit table is finite and non-negative (the
  premise of ``kernels/csrc/backlog_scan.cu``) and waits do not grow
  with ``b_max``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.traffic as pt
from repro_torch.kernels.backlog_scan import backlog_scan
from repro_torch.kernels.deposit import deposit
from repro_torch.traffic import admission as padm
from repro_torch.traffic import batching as pb
from repro_torch.traffic import queueing as pq
from test_torch_admission import AIMD, _scan_inputs, _same_admit
from test_torch_fleet import _assert_parity, _pair, ref  # noqa: F401

EPS = np.finfo(np.float64).eps


def _ref_batching():
    from repro.traffic import batching
    return batching


def _planes(rng, shape):
    """(work, work_dec, cnt) with work_dec <= work, counts in [0, 20)."""
    w = rng.uniform(0.0, 2.0, shape) * (rng.random(shape) < 0.6)
    wd = w * rng.uniform(0.0, 1.0, shape) * (rng.random(shape) < 0.7)
    c = rng.uniform(0.0, 20.0, shape) * (wd > 0)
    return w, wd, c


# --------------------------------------------------------------------- #
# Host numpy: bitwise
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [
    dict(), dict(b_max=1), dict(b_max=6, kv_slots_per_sat=4),
    dict(b_max=3, kv_slots_per_sat=9, window_s=0.12),
    dict(b_max=8, speedup=(1.0, 1.7, 1.5, 2.6)),
    dict(b_max=2, speedup=(0.5, 3.0, 4.0))])
def test_batching_config_matches_reference(ref, kw):
    """Fields, cap, window and the table, bare, from the calibrated
    service model and from the analytic one."""
    from repro.core import (ComputeConfig, MoEWorkload, ServiceModel,
                            load_table, resolve_service_model)

    from repro_torch import core as pc
    batching = _ref_batching()
    a, b = batching.BatchingConfig(**kw), pt.BatchingConfig(**kw)
    assert (b.b_cap, b.window_bins(0.05), b.window_bins(0.01)) == \
        (a.b_cap, a.window_bins(0.05), a.window_bins(0.01))
    np.testing.assert_array_equal(b.resolve_table(), a.resolve_table())
    svc = ServiceModel.calibrated(MoEWorkload.llama_moe_3p5b(),
                                  ComputeConfig(),
                                  load_table("llama-moe-3.5b"))
    psvc = pc.ServiceModel.calibrated(pc.MoEWorkload.llama_moe_3p5b(),
                                      pc.ComputeConfig(),
                                      pc.load_table("llama-moe-3.5b"))
    asvc = pc.resolve_service_model(None, pc.MoEWorkload.llama_moe_3p5b(),
                                    pc.ComputeConfig())
    rsvc = resolve_service_model(None, MoEWorkload.llama_moe_3p5b(),
                                 ComputeConfig())
    for s_ref, s_port in ((svc, psvc), (rsvc, asvc)):
        np.testing.assert_array_equal(b.resolve_table(s_port, 512),
                                      a.resolve_table(s_ref, 512))


@pytest.mark.parametrize("bad", [
    dict(b_max=0), dict(kv_slots_per_sat=-1), dict(window_s=-0.1),
    dict(speedup=()), dict(speedup=(1.0, np.inf)), dict(speedup=(1.0, 0.0)),
    dict(speedup=((1.0, 2.0),))])
def test_batching_config_refuses_what_the_reference_refuses(ref, bad):
    batching = _ref_batching()
    with pytest.raises(ValueError):
        batching.BatchingConfig(**bad)
    with pytest.raises(ValueError):
        pt.BatchingConfig(**bad)


@pytest.mark.parametrize("window", [1, 2, 7, 400])
def test_numpy_helpers_match_reference(ref, window):
    batching = _ref_batching()
    rng = np.random.default_rng(window)
    w, wd, c = _planes(rng, (3, 5, 200))
    table = pt.BatchingConfig(b_max=6, speedup=(1.0, 1.8, 2.4, 3.5)) \
        .resolve_table()
    np.testing.assert_array_equal(pb.windowed_counts(c, window),
                                  batching.windowed_counts(c, window))
    for x, y in zip(pb.batch_speedup_at(c, table, 6.0),
                    batching.batch_speedup_at(c, table, 6.0)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(pb.effective_work_np(w, wd, c, table, 6.0, window),
                    batching.effective_work_np(w, wd, c, table, 6.0,
                                               window)):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------- #
# The tensor law
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("window", [1, 3, 40])
@pytest.mark.parametrize("b_max", [1, 4, 8])
def test_tensor_law_matches_reference(ref, window, b_max):
    import jax
    batching = _ref_batching()
    rng = np.random.default_rng(10 * window + b_max)
    w, wd, c = _planes(rng, (4, 300))
    cfg = pt.BatchingConfig(b_max=b_max, speedup=(1.0, 1.9, 2.5, 3.1, 3.3))
    table = cfg.resolve_table()
    cw_np = pb.windowed_counts(c, window)
    cw = pb.windowed_counts_torch(torch.from_numpy(c), window)
    np.testing.assert_array_equal(cw.numpy(), cw_np)     # np.cumsum's order
    with jax.enable_x64(True):
        cw_ref = np.asarray(batching.windowed_counts_jnp(c, window))
        eff_ref, beff_ref = batching.batched_effective_work(
            w, wd, cw_np, table, float(cfg.b_cap))
        eff_ref, beff_ref = np.asarray(eff_ref), np.asarray(beff_ref)
    # XLA's cumsum sums in another order: two sums of T terms each.
    bound = 2 * c.shape[-1] * EPS * np.cumsum(c, axis=-1).max()
    np.testing.assert_allclose(cw.numpy(), cw_ref, rtol=0.0, atol=bound)
    if window == 1:
        np.testing.assert_array_equal(cw_ref, c)
    eff, beff = pb.batched_effective_work(
        torch.from_numpy(w), torch.from_numpy(wd), cw, torch.from_numpy(table),
        float(cfg.b_cap))
    np.testing.assert_array_equal(eff.numpy(), eff_ref)
    np.testing.assert_array_equal(beff.numpy(), beff_ref)
    eff_np, beff_np = pb.effective_work_np(w, wd, c, table, cfg.b_cap, window)
    np.testing.assert_array_equal(eff.numpy(), eff_np)
    np.testing.assert_array_equal(beff.numpy(), beff_np)
    if b_max == 1:
        np.testing.assert_array_equal(eff.numpy(), w)


def test_effective_plane_blocks_do_not_change_it(monkeypatch):
    """The fleet's law a few rows at a time equals the law in one block
    (and its float32 downcast), with B_eff at the recorded bins."""
    rng = np.random.default_rng(5)
    w, wd, c = (torch.from_numpy(x) for x in _planes(rng, (7, 50)))
    batch = dict(table=torch.tensor([1.0, 1.0, 1.5, 2.0, 2.2, 2.6, 2.6],
                                    dtype=torch.float64),
                 bcap=5.0, window=2)
    bins = torch.tensor([0, 3, 49])
    whole, beff_whole = pq._effective_plane(w, wd, c, batch, bins)
    monkeypatch.setattr(pq, "LAW_BLOCK_CELLS", 60)         # one row a block
    parts, beff_parts = pq._effective_plane(w, wd, c, batch, bins)
    eff, beff = pb.batched_effective_work(
        w, wd, pb.windowed_counts_torch(c, 2), batch["table"], 5.0)
    assert whole.dtype == torch.float32
    assert torch.equal(whole, eff.to(torch.float32))
    assert torch.equal(parts, whole) and torch.equal(beff_parts, beff_whole)
    assert torch.equal(beff_whole, beff[:, bins].to(torch.float32))


# --------------------------------------------------------------------- #
# The single-station law and the admission scan
# --------------------------------------------------------------------- #


SPEEDUP = (1.0, 1.6, 2.2, 2.5, 2.9)


@pytest.mark.parametrize("kw", [
    dict(b_max=1, speedup=SPEEDUP), dict(b_max=4, speedup=SPEEDUP),
    dict(b_max=8, window_s=0.15, speedup=SPEEDUP),
    dict(b_max=8, kv_slots_per_sat=3, speedup=SPEEDUP)])
def test_station_waiting_times_batching_matches_reference(ref, kw):
    """The FIFO tolerance of ``test_station_waiting_times_match_reference``
    (the reference's scan runs as float32 XLA code); batching never adds
    a wait."""
    _, queueing = ref
    batching = _ref_batching()
    rng = np.random.default_rng(6)
    t = np.sort(rng.random(400) * 20.0)
    s = rng.random(400) * 0.08
    want = queueing.station_waiting_times(
        t, s, 0.05, buffer_s=5.0, batching=batching.BatchingConfig(**kw))
    got = pq.station_waiting_times(t, s, 0.05, buffer_s=5.0, device="cpu",
                                   batching=pt.BatchingConfig(**kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    fifo = pq.station_waiting_times(t, s, 0.05, buffer_s=5.0, device="cpu")
    if kw["b_max"] == 1:
        np.testing.assert_array_equal(got, fifo)
    else:
        assert (got <= fifo).all() and (got < fifo).any()


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("window", [1, 4])
def test_admission_queue_scan_batching_matches_reference(ref, policy,
                                                         window):
    """The law inside the admission scan, on float32 planes as the host
    path passes them (the reference's jitted scan runs without x64).
    XLA contracts the law's last ``work + work_dec * c`` into one float32
    fused multiply-add; the port rounds the product and the sum apart.
    So the effective plane is held to the reference's within one float32
    rounding a cell, and the scan of the port's plane to the reference's
    scan of that same plane: wait and dropped bitwise, admit as
    ``test_torch_admission`` holds it."""
    import jax
    import jax.numpy as jnp
    traffic, _ = ref
    batching = _ref_batching()
    work, cap, ctrl, gw_idx, exp_idx, ttft0, tpot0 = _scan_inputs(
        600, 10, "capped")
    rng = np.random.default_rng(window)
    wd = (work * rng.random(work.shape)).astype(np.float32)
    cnt = rng.random(work.shape) * 9.0 * (wd > 0)
    cw = pb.windowed_counts(cnt, window).astype(np.float32)
    table = pt.BatchingConfig(b_max=8,
                              speedup=SPEEDUP).resolve_table().astype(
                                  np.float32)
    eff_ref = np.asarray(jax.jit(batching.batched_effective_work)(
        work, wd, cw, table, np.float32(8.0))[0])
    eff, _ = pb.batched_effective_work(
        *(torch.from_numpy(x) for x in (work, wd, cw, table)), 8.0)
    np.testing.assert_allclose(eff.numpy(), eff_ref, rtol=0.0,
                               atol=np.spacing(np.float32(work.max())))
    p, g = ttft0.shape
    pid = pid_t = None
    if policy == "pid":
        pid = dict(kp=jnp.asarray(0.4), ki=jnp.asarray(0.05),
                   kd=jnp.asarray(0.02), gain=jnp.asarray(np.ones(p)))
        pid_t = dict(kp=0.4, ki=0.05, kd=0.02,
                     gain=torch.ones(p, dtype=torch.float32))
    args = (0.05, ttft0, tpot0, ctrl, gw_idx, exp_idx,
            np.ones((p, g), np.float32), 2.0, 1.2, 0.1, 0.6, 0.05)
    want = traffic.admission_queue_scan(
        jnp.asarray(eff.numpy()), jnp.asarray(cap), args[0],
        *(jnp.asarray(a) for a in args[1:7]), *args[7:], pid=pid)
    scan_args = (float(cap), args[0],
                 *(torch.from_numpy(np.asarray(a)) for a in args[1:7]),
                 *args[7:])
    got = padm.admission_queue_scan(
        torch.from_numpy(work), *scan_args,
        batching=dict(work_dec=torch.from_numpy(wd),
                      cnt_win=torch.from_numpy(cw),
                      table=torch.from_numpy(table), bcap=8.0), pid=pid_t)
    w_r, d_r, a_r = (np.asarray(x) for x in want)
    w_p, d_p, a_p = (x.numpy() for x in got)
    np.testing.assert_array_equal(w_p, w_r)
    np.testing.assert_array_equal(d_p, d_r)
    _same_admit(a_p, a_r, policy)
    fifo = padm.admission_queue_scan(torch.from_numpy(work), *scan_args,
                                     pid=pid_t)[0].numpy()
    assert (w_p <= fifo).all() and (w_p < fifo).any()


# --------------------------------------------------------------------- #
# FleetSim(batching=) against the reference
# --------------------------------------------------------------------- #


def _bitwise(res_ref, res_port):
    _assert_parity(res_ref, res_port)
    for a, b in zip(res_ref.plans, res_port.plans):
        for name in ("ttft_s", "e2e_s", "tpot_s", "token_total_s"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                          err_msg=name)


def _same_outcome(res_ref, res_port):
    _assert_parity(res_ref, res_port)
    for pr, pp in zip(res_ref.plans, res_port.plans):
        if pr.shed is not None:
            np.testing.assert_array_equal(pp.shed, pr.shed)
            np.testing.assert_array_equal(pp.retries, pr.retries)


@pytest.mark.parametrize("kw", [
    dict(batching=dict(b_max=8)),
    dict(batching=dict(b_max=4, kv_slots_per_sat=3), qkw=dict(iterations=1)),
    dict(batching=dict(b_max=8, window_s=0.15)),
    dict(batching=dict(b_max=8), ground=True, admission=AIMD, rate=6.0),
    dict(batching=dict(b_max=8, window_s=0.15), ground=True, admission=AIMD,
         rate=6.0),
], ids=["window1", "kv-cap-1iter", "window3", "aimd-window1", "aimd-window3"])
def test_fleet_batching_matches_reference(ref, kw):
    kw = dict(dict(rate=12.0), **kw)
    sim, psim = _pair(ref, **kw)
    for name in ("_batch_table", "_chunk_wdec", "_chunk_cntw", "_f_wdec",
                 "_f_cntw"):
        np.testing.assert_array_equal(getattr(psim, name),
                                      getattr(sim, name), err_msg=name)
    assert (psim._batch_cap, psim._batch_window) == \
        (sim._batch_cap, sim._batch_window)
    window1 = "window_s" not in kw["batching"]
    res, pres = sim.run(), psim.run()
    (_bitwise if window1 else _same_outcome)(res, pres)
    _same_outcome(res, pres)
    assert any(p.served.any() for p in pres.plans)
    legacy, plegacy = sim.run_legacy(), psim.run_legacy()
    (_bitwise if window1 and "admission" not in kw else _same_outcome)(
        legacy, plegacy)
    _same_outcome(plegacy, pres)                # fused vs host path, port
    # Batching moved the outcome against FIFO.
    _, pfifo = _pair(ref, **{k: v for k, v in kw.items() if k != "batching"})
    assert any(not np.array_equal(a.ttft_s, b.ttft_s, equal_nan=True)
               for a, b in zip(pfifo.run().plans, pres.plans))


def test_fleet_batching_run_many_matches_reference(ref):
    sim, psim = _pair(ref, rate=12.0, batching=dict(b_max=8))
    u = np.random.default_rng(1).random(sim.n_requests)
    masks = u[None, :] < np.array([0.3, 0.7, 1.0])[:, None]
    for res, pres in zip(sim.run_many(masks), psim.run_many(masks)):
        _bitwise(res, pres)
    _bitwise(psim.run(active=masks[1]), psim.run_many(masks)[1])


@pytest.mark.parametrize("kw", [dict(), dict(ground=True, admission=AIMD,
                                             rate=6.0)],
                         ids=["plain", "aimd"])
def test_bmax1_is_bitwise_fifo(ref, kw):
    kw = dict(dict(rate=12.0), **kw)
    _, pfifo = _pair(ref, **kw)
    _, pone = _pair(ref, batching=dict(b_max=1, window_s=0.1), **kw)
    masks = np.random.default_rng(2).random((2, pone.n_requests)) < 0.6
    _bitwise(pfifo.run(), pone.run())
    _bitwise(pfifo.run_legacy(), pone.run_legacy())
    for a, b in zip(pfifo.run_many(masks), pone.run_many(masks)):
        _bitwise(a, b)


# --------------------------------------------------------------------- #
# Properties (hypothesis)
# --------------------------------------------------------------------- #

speedups = st.lists(st.floats(min_value=0.25, max_value=16.0,
                              allow_nan=False), min_size=1, max_size=10)


@given(seed=st.integers(0, 2 ** 32 - 1), sp=speedups,
       b_max=st.integers(1, 10), window=st.integers(1, 5),
       scale=st.sampled_from([1e-9, 1e-3, 1.0, 1e3]),
       mig=st.booleans())
@settings(max_examples=60, deadline=None)
def test_effective_work_is_finite_and_non_negative(seed, sp, b_max, window,
                                                   scale, mig):
    """A deposit table whose decode chunks are a subset of its work chunks,
    deposited in table order (the plain ``deposit``): the law's effective
    plane is finite and >= 0, before and after the float32 downcast, so
    ``backlog_scan.cu``'s premise holds without a check on the card."""
    rng = np.random.default_rng(seed)
    n_rows, n_bins, n = 5, 64, 400
    rows = torch.from_numpy(np.sort(rng.integers(0, n_rows, n)))
    cols = torch.from_numpy(rng.integers(0, n_bins, n))
    work = rng.exponential(scale, n) * (rng.random(n) < 0.9)
    dec = rng.random(n) < 0.6
    frac = rng.uniform(0.0, 1.0, n)
    planes = [deposit(rows, cols, torch.from_numpy(v), n_rows, n_bins)
              for v in (work, work * dec, frac * dec)]
    if mig:
        planes[0] = planes[0] + torch.from_numpy(
            rng.exponential(scale, (n_rows, n_bins)))
    cfg = pt.BatchingConfig(b_max=b_max, speedup=tuple(sp))
    batch = dict(table=torch.from_numpy(cfg.resolve_table()),
                 bcap=float(cfg.b_cap), window=window)
    eff32, _ = pq._effective_plane(*planes, batch)
    eff, _ = pb.batched_effective_work(
        planes[0], planes[1], pb.windowed_counts_torch(planes[2], window),
        batch["table"], batch["bcap"])
    for x in (eff, eff32):
        assert torch.isfinite(x).all() and (x >= 0).all()


@given(seed=st.integers(0, 2 ** 32 - 1), sp=speedups,
       b_lo=st.integers(1, 8), extra=st.integers(0, 4),
       window=st.integers(1, 4), cap=st.sampled_from([0.3, 2.0, 10.0]))
@settings(max_examples=60, deadline=None)
def test_waits_do_not_grow_with_b_max(seed, sp, b_lo, extra, window, cap):
    """A larger cap gives a pointwise larger speedup, so smaller effective
    work and, through the monotone scan step, no larger wait.  Slack: the
    law's interpolation may round 1 ulp the wrong way (``1 - frac``), which
    the float32 downcast can turn into one float32 ulp of a bin's work;
    the scan is 1-Lipschitz, so waits may differ by T such ulps."""
    rng = np.random.default_rng(seed)
    w, wd, c = _planes(rng, (6, 300))
    w, wd, c = (torch.from_numpy(x) for x in (w, wd, c))
    waits = []
    for b_max in (b_lo, b_lo + extra):
        cfg = pt.BatchingConfig(b_max=b_max, speedup=tuple(sp))
        table = torch.from_numpy(cfg.resolve_table())
        eff, _ = pb.batched_effective_work(
            w, wd, pb.windowed_counts_torch(c, window), table,
            float(cfg.b_cap))
        assert (eff <= w + 1e-12).all()
        waits.append(backlog_scan(eff.to(torch.float32).T.contiguous(),
                                  cap, 0.05))
    slack = w.shape[1] * np.spacing(np.float32(w.max()))
    assert (waits[1] <= waits[0] + slack).all()
    t = np.sort(rng.random(200) * 10.0)
    s = rng.random(200) * 0.08
    st_waits = [pq.station_waiting_times(
        t, s, 0.05, buffer_s=cap, device="cpu",
        batching=pt.BatchingConfig(b_max=b, speedup=tuple(sp)))
        for b in (b_lo, b_lo + extra)]
    assert (st_waits[1] <= st_waits[0] + 200 * np.spacing(np.float32(cap))
            ).all()
