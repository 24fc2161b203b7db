"""Named traffic scenarios for constellation-scale serving studies.

Counterpart of ``repro.traffic.scenarios`` (the same registry, draws and
seed discipline).  Every entry point that builds a simulator takes the
port's ``device`` among ``**sim_kwargs`` (CUDA unless the caller asks for
the CPU).

Each :class:`TrafficScenario` bundles an arrival process, request-length
distributions, queueing/KV parameters and a target SLO into a named,
reproducible configuration; :data:`SCENARIOS` is the registry that
benchmarks, the serve entry point and the examples all dispatch on.

``failure-storm`` reuses :mod:`repro_torch.distributed.elastic`: at the storm
time a fraction of each layer's expert satellites is knocked out and
the Theorem-1 machinery re-places their experts onto the survivors
(``replan_on_failure`` on the layer's expert ring), with the weight
:func:`~repro_torch.distributed.elastic.migration` bytes accounted.  The
post-storm fleet runs with colocated experts — the Sec. VI-B
multi-expert regime under degraded capacity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Constellation, MultiExpertPlan, PlacementPlan
from ..core.activation import ActivationModel
from ..core.device_placement import DevicePlacementPlan, TorusSpec
from ..core.latency import ComputeConfig, TopologySample
from ..core.workload import MoEWorkload
from ..distributed import migration, replan_on_failure

from .admission import AdmissionConfig
from .ground import GroundSegment
from .metrics import SLO, TrafficResult
from .queueing import FleetSim, QueueConfig
from .replan import (ReplanConfig, ReplanReport, replan_traffic,
                     replan_traffic_fused)
from .requests import RequestBatch, sample_requests


@dataclasses.dataclass(frozen=True)
class TrafficScenario:
    """A named, fully-specified serving workload.

    ``admission`` switches the fleet simulator from the static
    ``kv_slots`` cap to the latency-target AIMD controller with gateway
    retry (see :mod:`repro_torch.traffic.admission`); the ``*-controlled``
    registry entries are the canonical examples.
    """

    name: str
    description: str
    horizon_s: float = 120.0
    base_rate_rps: float = 0.3
    arrival: str = "poisson"            # poisson | diurnal | hotspot
    # request-length distributions (satellite serving is short-prompt:
    # the 7-GFLOPS class onboard compute makes long prefills minutes-long)
    prompt_median: int = 16
    prompt_sigma: float = 0.8
    prompt_max: int = 256
    decode_mean: int = 16
    decode_max: int = 128
    # arrival-shape knobs
    diurnal_amplitude: float = 0.6
    diurnal_period_s: float | None = None    # None: one cycle per horizon
    hotspot_station: int = 0
    hotspot_boost: float = 4.0
    station_weights: tuple[float, ...] | None = None
    # queueing / memory
    dt_s: float = 0.05
    buffer_s: float = 10.0
    kv_slots: int = 0
    tail_s: float = 120.0
    # wall-clock seconds per topology slot (None = constellation-derived;
    # re-placement scenarios pin a short slot so boundaries fall inside
    # the horizon)
    slot_period_s: float | None = None
    # adaptive admission (None = static kv_slots cap only)
    admission: AdmissionConfig | None = None
    # continuous re-placement (None = plans held for the whole horizon)
    replan: ReplanConfig | None = None
    # objective
    slo: SLO = SLO()
    # failure storm (None = no storm)
    failure_at_s: float | None = None
    failure_frac: float = 0.25

    def requests(self, rng: np.random.Generator, n_stations: int = 1,
                 rate_scale: float = 1.0) -> RequestBatch:
        """Sample this scenario's request trace.

        Args:
            rng: Randomness source for arrivals and lengths.
            n_stations: Ground-gateway count to spread arrivals over.
            rate_scale: Multiplier on the base arrival rate (overload /
                saturation studies).

        Returns:
            The sampled :class:`~repro_torch.traffic.requests.RequestBatch`.
        """
        period = self.diurnal_period_s or self.horizon_s
        return sample_requests(
            rng,
            rate_rps=self.base_rate_rps * rate_scale,
            horizon_s=self.horizon_s,
            n_stations=n_stations,
            station_weights=(None if self.station_weights is None
                             else np.asarray(self.station_weights)),
            arrival=self.arrival,
            diurnal_amplitude=self.diurnal_amplitude,
            diurnal_period_s=period,
            hotspot_station=self.hotspot_station,
            hotspot_boost=self.hotspot_boost,
            prompt_median=self.prompt_median,
            prompt_sigma=self.prompt_sigma,
            prompt_max=self.prompt_max,
            decode_mean=self.decode_mean,
            decode_max=self.decode_max,
        )

    def queue_config(self, slot_period_s: float | None = None) -> QueueConfig:
        """The scenario's :class:`~repro_torch.traffic.queueing.QueueConfig`.

        The scenario's own ``slot_period_s`` (when set) wins over the
        caller's (typically constellation-derived) value.
        """
        kw = dict(dt_s=self.dt_s, buffer_s=self.buffer_s,
                  kv_slots=self.kv_slots, tail_s=self.tail_s,
                  admission=self.admission)
        period = (self.slot_period_s if self.slot_period_s is not None
                  else slot_period_s)
        if period is not None:
            kw["slot_period_s"] = period
        return QueueConfig(**kw)


SCENARIOS: dict[str, TrafficScenario] = {
    s.name: s for s in (
        TrafficScenario(
            name="smoke",
            description="CI-sized steady Poisson trickle (fast, low load)",
            horizon_s=60.0, base_rate_rps=0.25, decode_mean=8,
            decode_max=32, prompt_median=8, prompt_max=64, tail_s=60.0,
        ),
        TrafficScenario(
            name="steady-state",
            description="homogeneous Poisson at moderate utilization",
            horizon_s=300.0, base_rate_rps=0.4, decode_mean=16,
        ),
        TrafficScenario(
            name="diurnal-peak",
            description="sinusoidal daily cycle, stations phased like "
                        "time zones (one cycle per horizon)",
            horizon_s=600.0, base_rate_rps=0.35, arrival="diurnal",
            diurnal_amplitude=0.8, decode_mean=16,
        ),
        TrafficScenario(
            name="regional-hotspot",
            description="flash crowd: 5x Gaussian surge on one region's "
                        "gateway mid-horizon",
            horizon_s=300.0, base_rate_rps=0.3, arrival="hotspot",
            hotspot_boost=5.0, decode_mean=16,
        ),
        TrafficScenario(
            name="failure-storm",
            description="25% of expert satellites lost mid-horizon; "
                        "experts re-placed on survivors via "
                        "distributed.elastic (multi-expert regime)",
            horizon_s=300.0, base_rate_rps=0.3, decode_mean=16,
            failure_at_s=150.0, failure_frac=0.25,
        ),
        TrafficScenario(
            name="regional-hotspot-controlled",
            description="regional-hotspot surge under the AIMD "
                        "latency-target admission controller "
                        "(gateway retry; replaces the static KV cap)",
            horizon_s=300.0, base_rate_rps=0.3, arrival="hotspot",
            hotspot_boost=5.0, decode_mean=16, kv_slots=0,
            admission=AdmissionConfig(ttft_target_s=30.0),
            slo=SLO(ttft_s=30.0),
        ),
        TrafficScenario(
            name="failure-storm-controlled",
            description="failure-storm with the AIMD admission "
                        "controller defending the TTFT target through "
                        "the post-storm degraded (multi-expert) fleet",
            horizon_s=300.0, base_rate_rps=0.3, decode_mean=16,
            failure_at_s=150.0, failure_frac=0.25, kv_slots=0,
            admission=AdmissionConfig(ttft_target_s=30.0),
            slo=SLO(ttft_s=30.0),
        ),
        TrafficScenario(
            name="regional-hotspot-replan",
            description="regional-hotspot surge under backlog-driven "
                        "per-slot re-placement (hysteresis + "
                        "migration-cost gate; statics ride along for "
                        "comparison)",
            horizon_s=300.0, base_rate_rps=0.3, arrival="hotspot",
            hotspot_boost=5.0, decode_mean=16, slot_period_s=60.0,
            replan=ReplanConfig(mode="backlog"),
        ),
        TrafficScenario(
            name="failure-storm-replan",
            description="failure-storm where both phases re-place per "
                        "slot from live backlog (post-storm: among the "
                        "elastic-degraded multi-expert plans)",
            horizon_s=300.0, base_rate_rps=0.3, decode_mean=16,
            failure_at_s=150.0, failure_frac=0.25, slot_period_s=60.0,
            replan=ReplanConfig(mode="backlog"),
        ),
    )
}


def get_scenario(name: str) -> TrafficScenario:
    """Look up a registry scenario by name (KeyError lists the options)."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None


# --------------------------------------------------------------------- #
# Failure storm: knock out expert satellites, re-place via elastic
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class StormReport:
    """Degraded plans + per-plan weight-migration accounting."""

    degraded_plans: list
    failed_positions: list[np.ndarray]   # per layer, failed expert ranks
    migration_bytes: dict[str, float]
    moved_experts: dict[str, int]


def apply_failure_storm(
    plans: list,
    activation: ActivationModel,
    rng: np.random.Generator,
    failure_frac: float = 0.25,
    bytes_per_expert: float = 1e6,
) -> StormReport:
    """Fail ``failure_frac`` of each layer's expert positions and re-run
    the Theorem-1 machinery on the survivors.

    Each layer's I expert satellites form a ring of I device slots
    (:class:`TorusSpec`); the failed *positions* are drawn once and
    shared by every plan of the sweep (a storm hits positions in the
    constellation, and the comparison should see the same storm).  The
    surviving satellites then host ceil(I / survivors) experts each —
    plans come back as :class:`MultiExpertPlan` with the elastic
    machinery's migration bytes accounted per plan.
    """
    n_layers, n_experts = activation.n_layers, activation.n_experts
    n_fail = max(1, int(round(failure_frac * n_experts)))
    if n_fail >= n_experts:
        raise ValueError("failure_frac would leave no surviving experts")
    ring = TorusSpec(shape=(n_experts,), wrap=True)
    failed_positions = [
        np.sort(rng.choice(n_experts, size=n_fail, replace=False))
        for _ in range(n_layers)
    ]

    # Pre-storm reference on the same ring: expert e sits on position e.
    identity = DevicePlacementPlan(
        expert_perm=np.arange(n_experts), device_cost_s=np.zeros(n_experts),
        experts_per_device=1, origin=0)

    degraded, mig_bytes, moved = [], {}, {}
    for plan in plans:
        old_sats = np.asarray(plan.expert_sats)
        new_sats = np.empty_like(old_sats)
        total_bytes, total_moved = 0.0, 0
        epd = 1
        for layer in range(n_layers):
            failed = set(int(x) for x in failed_positions[layer])
            new_plan, survivors = replan_on_failure(
                activation.weights[layer], activation.top_k, ring, failed)
            epd = new_plan.experts_per_device
            # device slot of each expert on the survivor ring -> satellite
            dev_of_expert = survivors[new_plan.inverse_perm // epd]
            new_sats[layer] = old_sats[layer][dev_of_expert]
            mig = migration(identity, new_plan, bytes_per_expert, survivors)
            total_moved += len(mig.moved_experts)
            total_bytes += mig.bytes_moved
        name = f"{getattr(plan, 'name', 'plan')}+storm"
        degraded.append(MultiExpertPlan(
            gateways=np.asarray(plan.gateways), expert_sats=new_sats,
            experts_per_sat=epd, name=name))
        mig_bytes[name] = total_bytes
        moved[name] = total_moved
    return StormReport(degraded_plans=degraded,
                       failed_positions=failed_positions,
                       migration_bytes=mig_bytes, moved_experts=moved)


# --------------------------------------------------------------------- #
# Scenario runner
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class ScenarioOutcome:
    """Everything one scenario run produces."""

    scenario: TrafficScenario
    result: TrafficResult                 # main phase (pre-storm plans)
    sim: FleetSim
    post_failure: TrafficResult | None = None
    storm: StormReport | None = None
    replan: ReplanReport | None = None         # main-phase controller
    post_replan: ReplanReport | None = None    # post-storm controller


def make_sim(
    scenario: TrafficScenario,
    plans: list[PlacementPlan | MultiExpertPlan],
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    ground: GroundSegment | None = None,
    constellation: Constellation | None = None,
    rate_scale: float = 1.0,
    requests: RequestBatch | None = None,
    **sim_kwargs,
) -> FleetSim:
    """Build the :class:`FleetSim` for a scenario (slot wall-clock period
    taken from the constellation's orbit when available)."""
    n_stations = ground.n_stations if ground is not None else 1
    if requests is None:
        requests = scenario.requests(rng, n_stations, rate_scale=rate_scale)
    slot_period = (constellation.cfg.orbital_period_s / topo.n_slots
                   if constellation is not None else None)
    qcfg = scenario.queue_config(slot_period)
    return FleetSim(plans, topo, activation, workload, compute, requests,
                    rng, qcfg=qcfg, ground=ground, **sim_kwargs)


def make_federation(
    scenario: TrafficScenario | str,
    n_members: int,
    constellation_cfg,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    fed_cfg=None,
    rate_scale: float = 1.0,
    requests: RequestBatch | None = None,
    home: np.ndarray | None = None,
    n_layers: int = 4,
    n_experts: int = 4,
    top_k: int = 2,
    min_elevation_deg: float = 10.0,
    **sim_kwargs,
):
    """Build a K-member :class:`~repro_torch.traffic.federation.FederationSim`
    world for a named scenario.

    Each member is an independently-planned constellation (its own
    topology sample, ground visibility and SpaceMoE placement plan over
    a fresh :class:`~repro_torch.core.Constellation` of the given config),
    all serving the scenario's single global request trace; the members
    are built on one shared time-bin grid via
    :func:`~repro_torch.traffic.federation.build_federation`, so the whole
    federation — including a nested rate sweep — costs one fixed point
    per overflow round.

    Args:
        scenario: Scenario name or instance (supplies the arrival
            process and queue/admission config).
        n_members: K, member constellations.
        constellation_cfg: One ``ConstellationConfig`` shared by all
            members (each samples its own topology/outages), or a list
            of K configs.
        workload: MoE workload shared by the federation.
        compute: Compute config shared by the federation.
        rng: Source of the member topology draws (split per member).
        fed_cfg: Optional
            :class:`~repro_torch.traffic.federation.FederationConfig`.
        rate_scale: Arrival-rate multiplier for the global trace.
        requests: Optional pre-built global trace (overrides the
            scenario's arrival process — the million-user bench feeds
            ``stream_requests`` output here).
        home: Optional (R,) member index per request (hotspot benches
            concentrate load on one member this way).
        n_layers / n_experts / top_k: Activation-model grid.
        min_elevation_deg: Gateway visibility threshold per member.
        **sim_kwargs: Extra :class:`FleetSim` keyword arguments
            (``device=`` among them).

    Returns:
        The :class:`~repro_torch.traffic.federation.FederationSim`.
    """
    from ..core import LinkConfig, sample_topology, spacemoe_plan
    from .federation import build_federation
    from .ground import build_ground_segment

    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    cfgs = (list(constellation_cfg)
            if isinstance(constellation_cfg, (list, tuple))
            else [constellation_cfg] * n_members)
    if len(cfgs) != n_members:
        raise ValueError(f"need {n_members} constellation configs")

    # One global trace: station ids are drawn against member 0's ground
    # segment (members share the gateway *sites*; visibility differs).
    link = LinkConfig()
    cons = [Constellation(c) for c in cfgs]
    grounds = [build_ground_segment(c, link,
                                    min_elevation_deg=min_elevation_deg)
               for c in cons]
    if requests is None:
        requests = scenario.requests(rng, grounds[0].n_stations,
                                     rate_scale=rate_scale)
    # Fixed per-member seeds: a factory must be deterministic — a
    # member rebuilt on the shared bin grid (build_federation's second
    # pass) has to sample the *same* topology.
    seeds = rng.integers(2**32, size=n_members)

    def factory(k):
        def build(min_bins=0):
            con, ground = cons[k], grounds[k]
            r = np.random.default_rng(seeds[k])
            topo = sample_topology(con, link, r)
            activ = ActivationModel.zipf(n_layers, n_experts, top_k,
                                         seed=k + 1)
            plans = [spacemoe_plan(con, topo, activ)]
            slot_period = con.cfg.orbital_period_s / topo.n_slots
            qcfg = scenario.queue_config(slot_period)
            return FleetSim(plans, topo, activ, workload, compute,
                            requests, r, qcfg=qcfg, ground=ground,
                            min_bins=min_bins, **sim_kwargs)
        return build

    return build_federation([factory(k) for k in range(n_members)],
                            fed_cfg, home=home, ground=grounds[0])


def run_scenario(
    scenario: TrafficScenario | str,
    plans: list[PlacementPlan | MultiExpertPlan],
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    ground: GroundSegment | None = None,
    constellation: Constellation | None = None,
    rate_scale: float = 1.0,
    bytes_per_expert: float = 1e6,
    ctrl: str = "host",
    **sim_kwargs,
) -> ScenarioOutcome:
    """Run one named scenario end-to-end.

    For ``failure-storm`` scenarios the trace is split at the storm
    time: the pre-storm phase runs the given plans, the post-storm phase
    runs the elastic-replanned (degraded, multi-expert) plans on the
    requests arriving after the storm.  Queue state does not carry over
    the boundary (the storm re-plan itself drains the fleet while
    weights migrate), and the migration bytes are reported.

    When ``scenario.replan`` is set, ``plans`` is the *candidate pool*
    of the re-placement controller (:mod:`repro_torch.traffic.replan`): each
    phase probes, decides a :class:`~repro_torch.core.schedule.PlanSchedule`
    and evaluates it alongside the static candidates, so the phase's
    result table carries one extra ``replan/<mode>`` row (for a storm
    scenario, the post phase re-places among the degraded plans).
    ``ctrl`` picks the controller implementation for those phases:
    ``"host"`` walks the pinned decide law round by round
    (:func:`~repro_torch.traffic.replan.replan_traffic`), ``"fused"``
    runs the same law as one call of the joint control plane per phase
    (:func:`~repro_torch.traffic.replan.replan_traffic_fused`, the same
    decisions as the host walk, and the report carries the decision-event
    channel).  ``device=`` goes among ``**sim_kwargs``.
    """
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    n_stations = ground.n_stations if ground is not None else 1
    requests = scenario.requests(rng, n_stations, rate_scale=rate_scale)
    slot_period = (constellation.cfg.orbital_period_s / topo.n_slots
                   if constellation is not None else None)
    # One per-expert byte price for the whole outcome: the storm
    # re-place accounting, the replan migration gate and the fleet's
    # queue billing must all agree.
    qcfg = dataclasses.replace(scenario.queue_config(slot_period),
                               migration_bytes_per_expert=bytes_per_expert)

    if ctrl not in ("host", "fused"):
        raise ValueError(f"unknown controller {ctrl!r} "
                         "(one of 'host', 'fused')")

    def _phase(phase_plans, phase_requests):
        """One phase: replan-controlled when the scenario asks for it."""
        if scenario.replan is not None:
            controller = replan_traffic if ctrl == "host" \
                else replan_traffic_fused
            out = controller(phase_plans, topo, activation, workload,
                             compute, phase_requests, rng,
                             scenario.replan, qcfg, ground=ground,
                             **sim_kwargs)
            return out.result, out.sim, out.report
        sim = FleetSim(phase_plans, topo, activation, workload, compute,
                       phase_requests, rng, qcfg=qcfg, ground=ground,
                       **sim_kwargs)
        return sim.run(), sim, None

    if scenario.failure_at_s is None:
        result, sim, report = _phase(plans, requests)
        return ScenarioOutcome(scenario=scenario, result=result, sim=sim,
                               replan=report)

    pre = requests.subset(requests.arrival_s < scenario.failure_at_s)
    post = requests.subset(requests.arrival_s >= scenario.failure_at_s)
    if pre.n_requests == 0:
        raise ValueError(
            f"failure_at_s={scenario.failure_at_s} precedes every arrival — "
            "nothing to simulate pre-storm")
    storm = apply_failure_storm(plans, activation, rng,
                                failure_frac=scenario.failure_frac,
                                bytes_per_expert=bytes_per_expert)
    result, sim, report = _phase(plans, pre)
    post_result, post_report = None, None
    if post.n_requests:
        post_result, _, post_report = _phase(storm.degraded_plans, post)
    return ScenarioOutcome(scenario=scenario, result=result, sim=sim,
                           post_failure=post_result, storm=storm,
                           replan=report, post_replan=post_report)
