"""The port's host modules of the world against the reference's: bitwise.

Constellation geometry, the topology sampler and its Dijkstra tables,
the workload accounting, the activation model, the planners, the
objective, plan schedules and the load side of calibration are host
numpy/scipy in both packages; the same inputs must give equal arrays
(``np.array_equal``) and equal floats.  The world is small:
8 x 12 satellites, 10 slots, 4 MoE layers, top-2.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as pc
from repro.core import calibration as rcal
from repro_torch.core import calibration as pcal

CFG_KW = dict(n_slots=10)


def _con(mod):
    return mod.Constellation(mod.ConstellationConfig.scaled(8, 12, **CFG_KW))


def _topo(mod, con, seed=0):
    return mod.sample_topology(con, mod.LinkConfig(),
                               np.random.default_rng(seed))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_constellation_matches_reference():
    r, p = _con(rc), _con(pc)
    assert dataclasses.asdict(r.cfg) == dataclasses.asdict(p.cfg)
    _eq(p.edges, r.edges)
    for t in (0.0, 137.5, 2100.0):
        _eq(p.positions(t), r.positions(t))
        _eq(p.edge_distances(t), r.edge_distances(t))
        _eq(p.los_angular_rates(t), r.los_angular_rates(t))
        _eq(p.occlusion_feasible(t), r.occlusion_feasible(t))
        _eq(p.tracking_feasible(t), r.tracking_feasible(t))
        _eq(p.sample_edge_mask(t, np.random.default_rng(3)),
            r.sample_edge_mask(t, np.random.default_rng(3)))
    _eq(p.cfg.slot_times(), r.cfg.slot_times())
    paper_r, paper_p = rc.ConstellationConfig(), pc.ConstellationConfig()
    assert (paper_p.n_sats, paper_p.n_slots) == (paper_r.n_sats,
                                                 paper_r.n_slots) == (1056, 200)


def test_topology_and_distance_tables_match_reference():
    r, p = _con(rc), _con(pc)
    tr, tp = _topo(rc, r), _topo(pc, p)
    _eq(tp.edge_mask, tr.edge_mask)
    _eq(tp.edge_latency, tr.edge_latency)
    assert tp.availability() == tr.availability()
    src = np.array([0, 5, 17, 50])
    _eq(pc.source_distance_table(tp, src), rc.source_distance_table(tr, src))
    sets = rc.subnet_routing_sets(r.cfg, 4)
    _eq(pc.gateway_distance_table(tp, src, pc.subnet_routing_sets(p.cfg, 4)),
        rc.gateway_distance_table(tr, src, sets))
    _eq(tp.distances_from(3, src), tr.distances_from(3, src))
    table = rc.gateway_distance_table(tr, src)
    _eq(pc.expected_path_latency(table, 1, 4, 0.01),
        rc.expected_path_latency(table, 1, 4, 0.01))
    link_r, link_p = rc.LinkConfig(), pc.LinkConfig()
    assert link_p.tx_latency_s == link_r.tx_latency_s
    assert pc.ComputeConfig().latency_s(3e9) == rc.ComputeConfig().latency_s(3e9)


def test_workload_matches_reference():
    r, p = rc.MoEWorkload.llama_moe_3p5b(), pc.MoEWorkload.llama_moe_3p5b()
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    for ctx in (1, 256, 1024):
        assert p.gateway_flops(ctx) == r.gateway_flops(ctx)
        assert p.attention_flops(ctx) == r.attention_flops(ctx)
        assert p.gateway_bytes(ctx) == r.gateway_bytes(ctx)
        assert p.gateway_token_bytes(ctx) == r.gateway_token_bytes(ctx)
    for name in ("expert_flops", "lm_head_flops", "expert_bytes",
                 "lm_head_bytes", "gateway_weight_bytes"):
        assert getattr(p, name) == getattr(r, name), name


def test_activation_model_matches_reference():
    r = rc.ActivationModel.zipf(4, 8, 2, seed=3)
    p = pc.ActivationModel.zipf(4, 8, 2, seed=3)
    _eq(p.weights, r.weights)
    _eq(p.all_probs(), r.all_probs())
    for layer in range(4):
        _eq(p.sample(layer, np.random.default_rng(layer), 500),
            r.sample(layer, np.random.default_rng(layer), 500))
    assert pc.subset_pmf(p.weights[0], 2) == rc.subset_pmf(r.weights[0], 2)
    counts = np.random.default_rng(0).integers(0, 50, (4, 8))
    _eq(pc.ActivationModel.from_router_counts(counts, 2).weights,
        rc.ActivationModel.from_router_counts(counts, 2).weights)


def test_planners_match_reference():
    r, p = _con(rc), _con(pc)
    tr, tp = _topo(rc, r), _topo(pc, p)
    ar = rc.ActivationModel.zipf(4, 4, 2, seed=1)
    ap = pc.ActivationModel.zipf(4, 4, 2, seed=1)
    for a, b in zip(rc.ring_subnets(r.cfg, 4), pc.ring_subnets(p.cfg, 4)):
        _eq(b, a)
    assert [pc.central_gateway(p.cfg, l, 4) for l in range(4)] == \
        [rc.central_gateway(r.cfg, l, 4) for l in range(4)]
    plans_r = rc.baseline_plans(r, tr, ar, np.random.default_rng(2))
    plans_p = pc.baseline_plans(p, tp, ap, np.random.default_rng(2))
    plans_r += [rc.multi_expert_plan(r, tr, ar, 2, mode=m)
                for m in ("slotted", "spread")]
    plans_p += [pc.multi_expert_plan(p, tp, ap, 2, mode=m)
                for m in ("slotted", "spread")]
    assert [x.name for x in plans_p] == [x.name for x in plans_r]
    for a, b in zip(plans_r, plans_p):
        _eq(b.gateways, a.gateways)
        _eq(b.expert_sats, a.expert_sats)


def test_objective_matches_reference():
    w = rc.ActivationModel.zipf(1, 6, 2, seed=4).weights[0]
    tau = np.sort(np.random.default_rng(1).random(6))
    perm = np.random.default_rng(2).permutation(6)
    assert pc.layer_latency_closed_form(tau, w, perm, 2) == \
        rc.layer_latency_closed_form(tau, w, perm, 2)
    assert pc.layer_latency_monte_carlo(
        tau, w, perm, 2, np.random.default_rng(3), 2000) == \
        rc.layer_latency_monte_carlo(tau, w, perm, 2,
                                     np.random.default_rng(3), 2000)
    pb, vb = pc.brute_force_optimal(tau, w, 2)
    rb, rv = rc.brute_force_optimal(tau, w, 2)
    _eq(pb, rb)
    assert vb == rv


def test_plan_schedules_match_reference():
    r, p = _con(rc), _con(pc)
    tr, tp = _topo(rc, r), _topo(pc, p)
    ar = rc.ActivationModel.zipf(4, 4, 2, seed=1)
    ap = pc.ActivationModel.zipf(4, 4, 2, seed=1)
    rp = [rc.spacemoe_plan(r, tr, ar),
          rc.rand_intra_cg_plan(r.cfg, 4, 4, np.random.default_rng(7))]
    pp = [pc.spacemoe_plan(p, tp, ap),
          pc.rand_intra_cg_plan(p.cfg, 4, 4, np.random.default_rng(7))]
    slot_plan = np.array([0, 1, 1, 0, 0, 1, 0, 1, 1, 1])
    rs = rc.PlanSchedule(plans=rp, slot_plan=slot_plan, name="s")
    ps = pc.PlanSchedule(plans=pp, slot_plan=slot_plan, name="s")
    _eq(ps.switch_slots(), rs.switch_slots())
    assert ps.total_migration_bytes(1e6) == rs.total_migration_bytes(1e6)
    for a, b in zip(rs.migrations_over(500.0, 20.0, 1e6),
                    ps.migrations_over(500.0, 20.0, 1e6)):
        assert a[0] == b[0]
        _eq(b[1].new_sats, a[1].new_sats)
        assert b[1].bytes_moved == a[1].bytes_moved
    for a, b in zip(rc.schedule.migration_matrix(rp, 1e6, r.cfg.n_sats),
                    pc.migration_matrix(pp, 1e6, p.cfg.n_sats)):
        _eq(b, a)
    t = np.linspace(0.0, 9000.0, 37)
    _eq(pc.slot_of_time(t, 300.0, 10), rc.slot_of_time(t, 300.0, 10))
    assert pc.as_schedule(pp[0], 10).is_constant


def test_calibration_table_copy_is_pinned_to_reference():
    """The port's copy of the committed table has the reference's content
    hash, and the service model reads the same numbers from it."""
    for name in rcal.list_tables():
        if (pcal.TABLE_DIR / f"{name}.json").exists():
            assert pcal.load_table(name).table_hash == \
                rcal.load_table(name).table_hash
    assert "llama-moe-3.5b" in pcal.list_tables()
    tp, tr = pcal.load_table("llama-moe-3.5b"), rcal.load_table("llama-moe-3.5b")
    assert tp.table_hash == tr.table_hash == tp.compute_hash()
    assert json.loads(pcal.table_path("llama-moe-3.5b").read_text()) == \
        json.loads(rcal.table_path("llama-moe-3.5b").read_text())


@pytest.mark.parametrize("mode", ["analytic", "calibrated", "host-units"])
def test_service_model_matches_reference(mode):
    wl_r, wl_p = rc.MoEWorkload.llama_moe_3p5b(), pc.MoEWorkload.llama_moe_3p5b()
    speed = np.linspace(0.5, 1.5, 96)
    if mode == "analytic":
        r = rc.resolve_service_model(None, wl_r, rc.ComputeConfig())
        p = pc.resolve_service_model(None, wl_p, pc.ComputeConfig())
    else:
        units = "host" if mode == "host-units" else "satellite"
        r = rc.ServiceModel.calibrated(wl_r, rc.ComputeConfig(),
                                       rc.load_table("llama-moe-3.5b"),
                                       units=units, sat_speed=speed)
        p = pc.ServiceModel.calibrated(wl_p, pc.ComputeConfig(),
                                       pc.load_table("llama-moe-3.5b"),
                                       units=units, sat_speed=speed)
    b = np.array([1, 2, 3, 8, 32])
    _eq(p.gateway_s(1024, batch=b), r.gateway_s(1024, batch=b))
    assert p.gateway_s(1024) == r.gateway_s(1024)
    _eq(p.expert_s(), r.expert_s())
    assert (p.expert_scalar, p.head_s) == (r.expert_scalar, r.head_s)
    _eq(p.batch_speedup(16), r.batch_speedup(16))
    _eq(p.decode_rate(b, 512), r.decode_rate(b, 512))
    assert p.energy_per_token(1024) == r.energy_per_token(1024)
    assert p.describe() == r.describe()
    if mode != "analytic":
        _eq(p.inv_speed(96), r.inv_speed(96))
    with pytest.raises(ValueError):
        pc.resolve_service_model("calibrated", wl_p, pc.ComputeConfig())
