"""The port's ground segment against the reference's, on the CPU.

``repro_torch.traffic.ground`` is host numpy copied from
``repro.traffic.ground``: every table is held to the reference bitwise,
on the same constellation (a scaled Walker world, built by each package
from the same configuration).  The reference's ``repro.traffic`` is
imported through the module fixture of ``tests/test_torch_fleet.py``
(the ``enable_x64`` shim).
"""
import numpy as np
import pytest

import repro_torch.core as pc
import repro_torch.traffic as pt
from repro.core import Constellation, ConstellationConfig, LinkConfig
from test_torch_fleet import ref  # noqa: F401  (module fixture)

CFG = dict(n_slots=10, survival_prob=1.0)
STATIONS = (("quito", -0.2, -78.5), ("reykjavik", 64.1, -21.9),
            ("perth", -31.9, 115.9))


def _cons(planes=6, per_plane=10):
    return (Constellation(ConstellationConfig.scaled(planes, per_plane, **CFG)),
            pc.Constellation(pc.ConstellationConfig.scaled(planes, per_plane,
                                                           **CFG)))


def _same_segment(a, b):
    assert (a.n_stations, a.n_slots, a.n_ranked) == \
        (b.n_stations, b.n_slots, b.n_ranked)
    assert a.min_elevation_deg == b.min_elevation_deg
    assert [(s.name, s.lat_deg, s.lon_deg) for s in a.stations] == \
        [(s.name, s.lat_deg, s.lon_deg) for s in b.stations]
    for name in ("ingress_sat", "uplink_s", "elevation_rad", "ingress_ranked",
                 "uplink_ranked_s", "elevation_ranked_rad", "ground_delay_s"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    assert b.coverage() == a.coverage()


def _segments(ref, custom, n_ranked, elev, planes=6, uplink=10.0):
    traffic, _ = ref
    con, pcon = _cons(planes)
    kw = dict(min_elevation_deg=elev, n_ranked=n_ranked,
              uplink_rate_gbps=uplink)
    if custom:
        kw_r = dict(kw, stations=tuple(traffic.GroundStation(*s)
                                       for s in STATIONS))
        kw_p = dict(kw, stations=tuple(pt.GroundStation(*s)
                                       for s in STATIONS))
    else:
        kw_r = kw_p = kw
    return (traffic.build_ground_segment(con, LinkConfig(), **kw_r),
            pt.build_ground_segment(pcon, pc.LinkConfig(), **kw_p))


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
@pytest.mark.parametrize("n_ranked", [1, 4])
@pytest.mark.parametrize("elev", [0.0, 10.0, 25.0, 60.0])
def test_build_ground_segment_matches_reference(ref, custom, n_ranked, elev):
    g, pg = _segments(ref, custom, n_ranked, elev)
    _same_segment(g, pg)


def test_ground_segment_at_explicit_slot_times(ref):
    traffic, _ = ref
    con, pcon = _cons(5)
    times = np.array([0.0, 17.5, 901.0, 4000.0])
    g = traffic.build_ground_segment(con, LinkConfig(), slot_times=times,
                                     min_elevation_deg=5.0, n_ranked=3)
    pg = pt.build_ground_segment(pcon, pc.LinkConfig(), slot_times=times,
                                 min_elevation_deg=5.0, n_ranked=3)
    _same_segment(g, pg)


def test_ground_segment_backfills_ranked_tables(ref):
    """A segment built from the rank-0 arrays alone fills its ranked
    tables and terrestrial delays as the reference's does."""
    traffic, _ = ref
    g, pg = _segments(ref, False, 4, 10.0)
    kw = dict(ingress_sat=g.ingress_sat, uplink_s=g.uplink_s,
              elevation_rad=g.elevation_rad, min_elevation_deg=10.0)
    _same_segment(traffic.GroundSegment(stations=g.stations, **kw),
                  pt.GroundSegment(stations=pg.stations, **kw))


@pytest.mark.parametrize("n_alt", [0, 1, 3, 7, 20])
def test_requests_map_and_retry_stations_match_reference(ref, n_alt):
    g, pg = _segments(ref, False, 4, 25.0)
    rng = np.random.default_rng(n_alt)
    slots = rng.integers(0, g.n_slots, 300)
    station = rng.integers(0, g.n_stations, 300)
    for a, b in zip(g.for_requests(slots, station),
                    pg.for_requests(slots, station)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(g.ranked_for_requests(slots, station),
                    pg.ranked_for_requests(slots, station)):
        np.testing.assert_array_equal(b, a)
    alt = g.retry_stations(slots, station, n_alt)
    palt = pg.retry_stations(slots, station, n_alt)
    np.testing.assert_array_equal(palt, alt)
    assert palt.shape == (300, min(n_alt, g.n_stations - 1))
    assert not (palt == station[:, None]).any()


def test_ground_delay_table_matches_reference(ref):
    traffic, _ = ref
    st = tuple(traffic.GroundStation(*s) for s in STATIONS) \
        + traffic.DEFAULT_STATIONS
    pst = tuple(pt.GroundStation(*s) for s in STATIONS) + pt.DEFAULT_STATIONS
    d, pd = traffic.ground_delay_table(st), pt.ground_delay_table(pst)
    np.testing.assert_array_equal(pd, d)
    assert (np.diag(pd) == 0).all()
    np.testing.assert_array_equal(
        np.stack([s.ecef() for s in pst]), np.stack([s.ecef() for s in st]))


@pytest.mark.parametrize("k,r", [(1, 5), (3, 40), (6, 1)])
def test_rank_constellations_matches_reference(ref, k, r):
    traffic, _ = ref
    rng = np.random.default_rng(k * r)
    costs = rng.random((k, r))
    costs[rng.random((k, r)) < 0.3] = np.inf
    costs[:, 0] = 0.25                               # a tie across all K
    np.testing.assert_array_equal(pt.rank_constellations(costs),
                                  traffic.rank_constellations(costs))


def test_rank_constellations_refuses_what_the_reference_refuses(ref):
    traffic, _ = ref
    for bad in (np.zeros(3), np.zeros((2, 2, 2))):
        with pytest.raises(ValueError):
            traffic.rank_constellations(bad)
        with pytest.raises(ValueError):
            pt.rank_constellations(bad)


def test_fleet_with_ground_matches_reference(ref):
    """FleetSim(ground=) without admission: ingress offsets and uplinks
    billed, unreachable requests failed, the run as the reference's."""
    import test_torch_fleet as tf
    traffic, _ = ref
    sim, psim = tf._pair(ref, rate=4.0, ground=True)
    np.testing.assert_array_equal(psim.ingress_extra, sim.ingress_extra)
    np.testing.assert_array_equal(psim.fail_ingress, sim.fail_ingress)
    assert psim.ingress_extra.max() > 0.0
    tf._assert_parity(sim.run(), psim.run())
    tf._assert_parity(sim.run_legacy(), psim.run_legacy())
    tf._assert_parity(sim.run(zero_load=True), psim.run(zero_load=True))


def test_simulate_traffic_with_ground_matches_reference(ref):
    import test_torch_fleet as tf
    traffic, _ = ref
    (topo, act, plans), (ptopo, pact, pplans) = tf._worlds(4)
    g, pg = tf._grounds()
    kw = dict(tf.REQ_KW, n_stations=g.n_stations)
    req = traffic.sample_requests(np.random.default_rng(2), rate_rps=2.0,
                                  horizon_s=20.0, **kw)
    preq = pt.sample_requests(np.random.default_rng(2), rate_rps=2.0,
                              horizon_s=20.0, **kw)
    from repro.core import ComputeConfig, MoEWorkload
    q = dict(dt_s=0.05, tail_s=30.0)
    a = traffic.simulate_traffic(plans, topo, act, MoEWorkload.llama_moe_3p5b(),
                                 ComputeConfig(), req,
                                 np.random.default_rng(5),
                                 qcfg=traffic.QueueConfig(**q), ground=g)
    b = pt.simulate_traffic(pplans, ptopo, pact,
                            pc.MoEWorkload.llama_moe_3p5b(),
                            pc.ComputeConfig(), preq,
                            np.random.default_rng(5),
                            qcfg=pt.QueueConfig(**q), ground=pg,
                            device="cpu")
    tf._assert_parity(a, b)
