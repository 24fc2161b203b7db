"""Parity of public names of the port that no other test holds to the
reference: the arrival processes and length samplers of ``traffic``,
``simulate_traffic``, and ``core``'s ``sample_topk``, ``rand_intra_plan``,
``migration_between``, ``save_table``, ``contention_counts``,
``hop_latency``, and ``models.init_cache``.

Host numpy functions get the same seeded generators in both packages and
are held bitwise.  ``contention_counts`` and ``hop_latency`` are jnp in
the reference and torch in the port: the same numpy inputs, bitwise (an
integer count; a gather plus one f32 multiply-add of a 0/1 mask, whose
product is exact).  ``repro.traffic`` is imported through the module
fixture of ``tests/test_torch_fleet.py`` (the ``enable_x64`` shim).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as pc
import repro_torch.traffic as pt
from repro.core import engine as jengine
from repro_torch.core import engine as pengine
from test_torch_fleet import REQ_KW, _assert_parity, _worlds, ref  # noqa: F401

# --------------------------------------------------------------------- #
# traffic: arrival processes and length samplers
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("rate,horizon", [(3.0, 100.0), (0.05, 10.0),
                                          (0.0, 10.0), (2.0, 0.0),
                                          (500.0, 30.0)])
def test_poisson_arrivals_match_reference(ref, rate, horizon):
    traffic, _ = ref
    a = traffic.poisson_arrivals(rate, horizon, np.random.default_rng(4))
    b = pt.poisson_arrivals(rate, horizon, np.random.default_rng(4))
    np.testing.assert_array_equal(b, a)
    assert b.dtype == a.dtype


@pytest.mark.parametrize("fn", ["diurnal", "hotspot"])
def test_rate_shapes_match_reference(ref, fn):
    traffic, _ = ref
    t = np.linspace(-50.0, 900.0, 1001)
    if fn == "diurnal":
        for amp, phase in ((0.0, 0.0), (0.7, 1.3), (1.5, -0.4)):
            np.testing.assert_array_equal(
                pt.diurnal_rate(t, 4.0, amp, 300.0, phase),
                traffic.diurnal_rate(t, 4.0, amp, 300.0, phase))
    else:
        for boost, width in ((0.0, 10.0), (3.0, 25.0), (10.0, 1.0)):
            np.testing.assert_array_equal(
                pt.hotspot_rate(t, 2.0, boost, 400.0, width),
                traffic.hotspot_rate(t, 2.0, boost, 400.0, width))
    assert pt.diurnal_rate(3.0, 1.0, 0.5, 10.0).shape == ()


def _rate_fns(traffic_mod):
    return (lambda t: traffic_mod.diurnal_rate(t, 5.0, 0.8, 200.0),
            lambda t: traffic_mod.hotspot_rate(t, 1.0, 4.0, 150.0, 30.0))


@pytest.mark.parametrize("which", [0, 1])
def test_thinned_arrivals_match_reference(ref, which):
    traffic, _ = ref
    fa, fb = _rate_fns(traffic)[which], _rate_fns(pt)[which]
    a = traffic.thinned_arrivals(fa, 9.0, 500.0, np.random.default_rng(9))
    b = pt.thinned_arrivals(fb, 9.0, 500.0, np.random.default_rng(9))
    np.testing.assert_array_equal(b, a)


def test_thinned_arrivals_envelope_errors_match_reference(ref):
    """An envelope below the rate raises in both; ``clip=True`` clips with
    a warning, to the same arrivals."""
    traffic, _ = ref
    fa, fb = _rate_fns(traffic)[0], _rate_fns(pt)[0]
    with pytest.raises(ValueError) as want:
        traffic.thinned_arrivals(fa, 3.0, 300.0, np.random.default_rng(1))
    with pytest.raises(ValueError) as got:
        pt.thinned_arrivals(fb, 3.0, 300.0, np.random.default_rng(1))
    assert str(got.value) == str(want.value)
    with pytest.warns(Warning):
        a = traffic.thinned_arrivals(fa, 3.0, 300.0, np.random.default_rng(1),
                                     clip=True)
    with pytest.warns(Warning):
        b = pt.thinned_arrivals(fb, 3.0, 300.0, np.random.default_rng(1),
                                clip=True)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shard_s", [600.0, 37.0, 1e4])
def test_stream_arrivals_match_reference(ref, shard_s):
    traffic, _ = ref
    fa, fb = _rate_fns(traffic)[1], _rate_fns(pt)[1]
    a, na = traffic.stream_arrivals(fa, 5.0, 700.0, np.random.default_rng(3),
                                    shard_s=shard_s)
    b, nb = pt.stream_arrivals(fb, 5.0, 700.0, np.random.default_rng(3),
                               shard_s=shard_s)
    np.testing.assert_array_equal(b, a)
    assert nb == na


@pytest.mark.parametrize("kw", [dict(), dict(median=16, sigma=0.3,
                                             max_len=64),
                                dict(median=0, max_len=1)])
def test_sample_prompt_lens_match_reference(ref, kw):
    traffic, _ = ref
    np.testing.assert_array_equal(
        pt.sample_prompt_lens(500, np.random.default_rng(5), **kw),
        traffic.sample_prompt_lens(500, np.random.default_rng(5), **kw))


@pytest.mark.parametrize("kw", [dict(), dict(mean=3, max_len=8),
                                dict(mean=0, max_len=2)])
def test_sample_decode_lens_match_reference(ref, kw):
    traffic, _ = ref
    np.testing.assert_array_equal(
        pt.sample_decode_lens(500, np.random.default_rng(6), **kw),
        traffic.sample_decode_lens(500, np.random.default_rng(6), **kw))


def test_simulate_traffic_matches_reference(ref):
    traffic, _ = ref
    (topo, act, plans), (ptopo, pact, pplans) = _worlds(4)
    req = traffic.sample_requests(np.random.default_rng(2), rate_rps=3.0,
                                  horizon_s=20.0, **REQ_KW)
    preq = pt.sample_requests(np.random.default_rng(2), rate_rps=3.0,
                              horizon_s=20.0, **REQ_KW)
    q = dict(dt_s=0.05, tail_s=30.0, kv_slots=3)
    a = traffic.simulate_traffic(plans, topo, act,
                                 jcore.MoEWorkload.llama_moe_3p5b(),
                                 jcore.ComputeConfig(), req,
                                 np.random.default_rng(5),
                                 qcfg=traffic.QueueConfig(**q))
    b = pt.simulate_traffic(pplans, ptopo, pact,
                            pc.MoEWorkload.llama_moe_3p5b(),
                            pc.ComputeConfig(), preq,
                            np.random.default_rng(5),
                            qcfg=pt.QueueConfig(**q), device="cpu")
    _assert_parity(a, b)


# --------------------------------------------------------------------- #
# core
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n,k,n_draws", [(8, 2, 1), (8, 2, 500), (16, 4, 64),
                                         (5, 5, 10), (3, 1, 7)])
def test_sample_topk_matches_reference(n, k, n_draws):
    w = np.random.default_rng(n * k).gamma(0.7, 1.0, n)
    a = jcore.sample_topk(w, k, np.random.default_rng(11), n_draws)
    b = pc.sample_topk(w, k, np.random.default_rng(11), n_draws)
    np.testing.assert_array_equal(b, a)
    assert b.shape == (n_draws, k)


@pytest.mark.parametrize("planes,per_plane,n_layers,n_experts",
                         [(8, 12, 4, 4), (33, 32, 32, 8), (5, 6, 3, 2)])
def test_rand_intra_plan_matches_reference(planes, per_plane, n_layers,
                                           n_experts):
    a = jcore.rand_intra_plan(
        jcore.ConstellationConfig.scaled(planes, per_plane), n_layers,
        n_experts, np.random.default_rng(2))
    b = pc.rand_intra_plan(
        pc.ConstellationConfig.scaled(planes, per_plane), n_layers,
        n_experts, np.random.default_rng(2))
    assert b.name == a.name
    np.testing.assert_array_equal(b.gateways, a.gateways)
    np.testing.assert_array_equal(b.expert_sats, a.expert_sats)


@pytest.mark.parametrize("slot", [-1, 3])
def test_migration_between_matches_reference(slot):
    cfg = dict(n_slots=10, survival_prob=1.0)
    jc = jcore.ConstellationConfig.scaled(8, 12, **cfg)
    tc = pc.ConstellationConfig.scaled(8, 12, **cfg)
    a0 = jcore.rand_intra_plan(jc, 4, 4, np.random.default_rng(1))
    a1 = jcore.rand_place_plan(jc, 4, 4, np.random.default_rng(2))
    b0 = pc.rand_intra_plan(tc, 4, 4, np.random.default_rng(1))
    b1 = pc.rand_place_plan(tc, 4, 4, np.random.default_rng(2))
    for x, y in ((a0, a1), (a0, a0)):
        mx = jcore.migration_between(x, y, 2.5e6, slot=slot)
        my = pc.migration_between(b0 if x is a0 else b1,
                                  b1 if y is a1 else b0, 2.5e6, slot=slot)
        for f in dataclasses.fields(mx):
            np.testing.assert_array_equal(getattr(my, f.name),
                                          getattr(mx, f.name), err_msg=f.name)
        assert my.n_moved == mx.n_moved


def test_save_table_writes_the_reference_bytes(tmp_path):
    a = jcore.load_table("llama-moe-3.5b")
    b = pc.load_table("llama-moe-3.5b")
    pa = jcore.save_table(a, tmp_path / "ref")
    pb = pc.save_table(b, tmp_path / "port")
    assert pa.name == pb.name
    assert pb.read_bytes() == pa.read_bytes()
    again = pc.load_table("llama-moe-3.5b", tmp_path / "port")
    assert again.to_dict() == b.to_dict()


@pytest.mark.parametrize("shape", [(6, 2), (3, 5, 4), (2, 3, 7, 8)])
def test_contention_counts_match_reference(shape):
    sats = np.random.default_rng(len(shape)).integers(0, 5, shape)
    a = np.asarray(jengine.contention_counts(jnp.asarray(sats)))
    b = pengine.contention_counts(torch.from_numpy(sats)).numpy()
    np.testing.assert_array_equal(b, a)
    assert (b >= 1).all()


@pytest.mark.parametrize("stale", [False, True])
def test_hop_latency_matches_reference(stale):
    rng = np.random.default_rng(5)
    n_t, v, t, k = 4, 9, 50, 3
    dist = (rng.random((n_t, v, v)) * 0.02).astype(np.float32)
    dist[rng.random((n_t, v, v)) < 0.05] = np.inf
    dist[:, np.arange(v), np.arange(v)] = 0.0
    slots = rng.integers(0, n_t, t)
    stale_slots = np.maximum(slots - 1, 0)
    g = rng.integers(0, v, (t, 1))
    sats = rng.integers(0, v, (t, k))
    a = np.asarray(jengine.hop_latency(
        jnp.asarray(dist), jnp.asarray(slots), jnp.asarray(stale_slots),
        jnp.asarray(g), jnp.asarray(sats), np.float32(0.01), stale))
    b = pengine.hop_latency(
        torch.from_numpy(dist), torch.from_numpy(slots)[:, None],
        torch.from_numpy(stale_slots)[:, None], torch.from_numpy(g),
        torch.from_numpy(sats), np.float32(0.01), stale).numpy()
    np.testing.assert_array_equal(b, a)
    if stale:
        assert (b > np.asarray(jengine.hop_latency(
            jnp.asarray(dist), jnp.asarray(slots), jnp.asarray(stale_slots),
            jnp.asarray(g), jnp.asarray(sats), 0.0, False))).any()


# --------------------------------------------------------------------- #
# models
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    """The port keeps one (k, v) cache a layer where the reference stacks
    them per scan unit: the same shapes, dtype and zeros layer by layer."""
    import repro.models as jmodels
    import repro_torch.models as tmodels
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.models.config import ModelConfig as TConfig
    kw = dict(name="t", n_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=128, compute_dtype=dtype)
    jc, tc = JConfig(**kw), TConfig(**kw)
    want = jmodels.init_cache(jc, 2, 11)
    got = tmodels.init_cache(tc, 2, 11, device="cpu")
    assert len(got["layers"]) == jc.n_layers
    units = want["units"]
    per_unit = len(units)
    for layer, lc in enumerate(got["layers"]):
        ref_block = units[f"b{layer % per_unit}"]
        for name in ("k", "v"):
            r = np.asarray(ref_block[name][layer // per_unit]
                           .astype(jnp.float32))
            assert tuple(lc[name].shape) == r.shape
            assert str(lc[name].dtype).split(".")[-1] == \
                str(ref_block[name].dtype)
            np.testing.assert_array_equal(lc[name].float().numpy(), r)


# --------------------------------------------------------------------- #
# batching and obs: the names the port exports
# --------------------------------------------------------------------- #

#: The names of ``repro.traffic`` that each module of it exports.
TRAFFIC_NAMES = {
    "batching": {"BatchingConfig", "batched_effective_work",
                 "effective_work_np", "windowed_counts"},
    "replan": {"ReplanConfig", "ReplanDecision", "ReplanOutcome",
               "ReplanReport", "backlog_penalty_s", "build_replan_schedule",
               "replan_base_scores", "replan_traffic",
               "replan_traffic_fused"},
}


@pytest.mark.parametrize("module", ["obs", "traffic.batching",
                                    "traffic.replan"])
def test_batching_and_obs_names_match_reference(ref, module):
    """Every public name of ``repro.obs``, and every batching and replan
    name of ``repro.traffic``, is exported by the port."""
    import repro.obs as robs
    import repro_torch.obs as pobs
    traffic, _ = ref
    if module == "obs":
        assert set(pobs.__all__) == set(robs.__all__)
        for n in pobs.__all__:
            assert hasattr(pobs, n)
    else:
        sub = module.split(".")[1]
        names = {n for n in traffic.__all__
                 if getattr(getattr(traffic, n), "__module__", None)
                 == f"repro.traffic.{sub}"}
        assert names == TRAFFIC_NAMES[sub]
        assert names <= set(pt.__all__)
        for n in names:
            assert callable(getattr(pt, n))
            assert getattr(pt, n).__module__ == f"repro_torch.traffic.{sub}"


def test_decision_trace_and_request_record_match_reference():
    """The host dataclasses' derived properties, on the same numbers."""
    from repro.obs import probes as rprobes
    from repro.obs import recorder as rrec

    from repro_torch.obs import probes as pprobes
    from repro_torch.obs import recorder as prec
    rng = np.random.default_rng(4)
    kw = dict(period_s=300.0, boundaries=np.array([1, 2, 5]),
              slots=np.array([1, 2, 5]), scores=rng.random((3, 4)),
              chosen=np.array([0, 2, 2]),
              switched=np.array([False, True, False]),
              migration_bytes=np.array([0.0, 3e6, 0.0]))
    a, b = rprobes.DecisionTrace(**kw), pprobes.DecisionTrace(**kw)
    assert (b.n_decisions, b.n_switches) == (a.n_decisions, a.n_switches)
    np.testing.assert_array_equal(b.t_s, a.t_s)
    rec = dict(rid=3, station=1, arrival_s=2.5, prompt_len=7, decode_len=4,
               active=True, served=True, shed=False, retries=1,
               ingress_s=0.01, ttft_s=1.25, tpot_s=0.5, e2e_s=3.25,
               layer_zero_s=rng.random(4), layer_gw_wait_s=rng.random(4),
               layer_ex_wait_s=rng.random(4), batch_b=2.5)
    ra, rb = rrec.RequestRecord(**rec), prec.RequestRecord(**rec)
    assert (rb.prefill_span, rb.decode_span, rb.queue_wait_s) == \
        (ra.prefill_span, ra.decode_span, ra.queue_wait_s)
    log = dict(plan_names=["a"], plan=0, dt_s=0.05, n_bins=400, events=[],
               probes=None)
    la = rrec.FlightLog(requests=[ra], **log)
    lb = prec.FlightLog(requests=[rb], **log)
    assert lb.horizon_s == la.horizon_s
    assert [r.rid for r in lb.served()] == [r.rid for r in la.served()]
