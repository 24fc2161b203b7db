"""Continuous re-placement under traffic: backlog-driven plan scheduling.

Counterpart of ``repro.traffic.replan`` (host numpy and the port's
engine and fleet simulator; the same arithmetic, draws and seed
discipline), built on :class:`~repro_torch.core.schedule.PlanSchedule`:
every topology
slot the controller re-ranks the candidate plans — the cheap batched
``evaluate_plans`` sweep with tokens pinned to the slot — and assembles
a schedule, with **hysteresis** and a **migration-cost gate** deciding
whether a switch is worth the weight bytes it moves.

Scoring (pinned)
----------------
A candidate's score at a decision boundary is its predicted per-token
latency under the *live* queue state::

    score[c] = mean zero-load latency at this slot        (engine sweep)
             + drop_rate[c] * drop_penalty_s              (delivery first)
             + sum_l backlog[gateway_l(c)]
             + sum_l max_i backlog[sat(expert_{l,i}(c))]  (backlog inflation)

The backlog term is the same critical-path estimate the admission
controller's qhat uses (gateway chain plus per-layer worst expert
queue), read from the per-satellite backlog the fleet simulator
observed at the boundary — plans whose satellites are drowning score
badly even if their geometry is ideal.  The incumbent is replaced by
the best candidate only when the predicted gain clears both gates::

    gain > hysteresis * score[incumbent]
         + migration_bytes(incumbent -> best) * weight_s_per_mb / 1e6

so oscillation is damped and a switch must amortize the weights it
drags across ISLs (the ``distributed.elastic`` byte accounting via
:func:`~repro_torch.core.schedule.migration_between`).

:func:`replan_traffic` closes the loop the way a live controller would:
a **probe** fleet run under the static candidates observes the backlog
each boundary, the controller **decides** the schedule from those
observations, and the final fleet run **evaluates** the schedule (with
its migration bytes riding the queues as background load) side by side
with every static candidate — one sweep, common random numbers.
:func:`replan_traffic_fused` runs the same loop as one call of the joint
control plane (``FleetSim.run_replan_grid``) on the simulator's device.

Every function that evaluates plans or builds a simulator takes the
port's ``device`` (CUDA unless the caller asks for the CPU): a keyword of
the scoring functions, one of ``**sim_kwargs`` for the two loops.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.activation import ActivationModel
from ..core.engine import PlanBatch, evaluate_plans
from ..core.latency import ComputeConfig, TopologySample
from ..core.schedule import PlanSchedule, migration_between
from ..core.workload import MoEWorkload

from .ground import GroundSegment
from .metrics import TrafficResult
from .queueing import FleetSim, QueueConfig
from .requests import RequestBatch

REPLAN_MODES = ("off", "periodic", "backlog")


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Re-placement controller parameters.

    Attributes:
        mode: ``"off"`` picks the best plan once at t=0 and holds it;
            ``"periodic"`` re-ranks on zero-load scores every
            ``period_slots`` boundaries; ``"backlog"`` additionally
            inflates scores with the live per-satellite backlog.
        period_slots: Decision cadence in topology-slot boundaries.
        hysteresis: Fractional predicted-latency gain a switch must
            clear (damps oscillation between near-tied plans).
        migration_weight_s_per_mb: Switching-cost gate — seconds of
            predicted-latency gain demanded per megabyte of expert
            weights the switch moves.
        bytes_per_expert: Weight bytes per migrated expert (the
            ``distributed.elastic`` accounting unit).  ``None`` (the
            default) inherits the fleet's
            :attr:`~repro_torch.traffic.queueing.QueueConfig
            .migration_bytes_per_expert` in :func:`replan_traffic`, so
            the gate prices exactly what the queues will bill.
        n_tokens: Monte-Carlo tokens per slot decision (the batched
            engine sweep is cheap; draws are shared across boundaries —
            common random numbers).
        drop_penalty_s: Latency charged per undeliverable token so
            delivery dominates speed in the ranking (mirrors
            ``rank_plans``'s drop-first ordering).
        controller_iterations: Decide/observe fixed-point rounds in
            :func:`replan_traffic`.  Round 1 observes the static probe
            rows; each further round re-observes the backlog of the
            *assembled schedule's own* fleet row and re-decides — the
            static rows cannot see the load a switching schedule leaves
            behind on previously-used satellites, so a second round
            damps switch-back oscillation.
    """

    mode: str = "backlog"
    period_slots: int = 1
    hysteresis: float = 0.05
    migration_weight_s_per_mb: float = 0.01
    bytes_per_expert: float | None = None
    n_tokens: int = 128
    drop_penalty_s: float = 60.0
    controller_iterations: int = 2

    def __post_init__(self):
        """Validate the controller parameters."""
        if self.mode not in REPLAN_MODES:
            raise ValueError(
                f"unknown replan mode {self.mode!r}; one of {REPLAN_MODES}")
        if self.period_slots < 1:
            raise ValueError("period_slots must be >= 1")
        if self.hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        if self.migration_weight_s_per_mb < 0.0:
            raise ValueError("migration_weight_s_per_mb must be >= 0")
        if self.n_tokens < 1:
            raise ValueError("n_tokens must be >= 1")
        if self.controller_iterations < 1:
            raise ValueError("controller_iterations must be >= 1")


@dataclasses.dataclass
class ReplanDecision:
    """One boundary's controller outcome."""

    boundary: int              # wall-clock boundary index k (t = k * period)
    slot: int                  # topology slot entered (k mod N_T)
    chosen: int                # candidate index in effect after the boundary
    switched: bool
    scores: np.ndarray         # (C,) backlog-inflated predicted cost
    migration_bytes: float     # bytes the switch moved (0.0 if held)

    def t_s(self, slot_period_s: float) -> float:
        """Wall-clock seconds of this decision's boundary."""
        return float(self.boundary) * float(slot_period_s)


@dataclasses.dataclass
class ReplanReport:
    """The controller's full trajectory and the schedule it assembled.

    ``trace`` is the joint control plane's decision-event channel
    (:class:`repro_torch.obs.probes.DecisionTrace`) — set only by the fused
    grid path, where the decisions are device telemetry rather than a
    host walk; the host controller leaves it ``None``.
    """

    schedule: PlanSchedule
    decisions: list[ReplanDecision]
    candidates: list
    trace: "DecisionTrace | None" = None

    @property
    def n_switches(self) -> int:
        """Number of boundaries where the plan actually changed."""
        return int(sum(bool(d.switched) for d in self.decisions))

    @property
    def total_migration_bytes(self) -> float:
        """Weight bytes moved across every *decided* switch.

        The fleet's per-row ``PlanTraffic.migration_bytes`` bills every
        boundary its horizon actually crosses — including the periodic
        replay of the schedule past one slot wrap (e.g. the wrap back
        to the slot-0 plan during a long drain tail) — so the two can
        differ when the simulated horizon outruns the decision walk.
        """
        return float(sum(d.migration_bytes for d in self.decisions))

    def events(self, slot_period_s: float) -> list:
        """The decision trajectory as flight-recorder control events
        (one :class:`~repro_torch.obs.recorder.ControlEvent` instant per
        boundary; switches carry their migration byte flow) — the hook
        ``serve.py --trace`` and the exporter consume."""
        from ..obs.recorder import replan_events
        return replan_events(self, slot_period_s)


def backlog_penalty_s(plan, sat_backlog: np.ndarray) -> float:
    """Critical-path backlog a request routed by ``plan`` would find:
    the gateway chain plus, per layer, the worst expert satellite — the
    same conservative qhat shape the admission law uses."""
    sat_backlog = np.asarray(sat_backlog)
    sats = np.asarray(plan.expert_sats)
    return float(sat_backlog[np.asarray(plan.gateways)].sum()
                 + sat_backlog[sats].max(axis=1).sum())


def build_replan_schedule(
    candidates: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    rcfg: ReplanConfig,
    horizon_s: float,
    slot_period_s: float,
    backlog_at=None,
    name: str | None = None,
    device="cuda",
) -> ReplanReport:
    """Walk the wall-clock slot boundaries of ``[0, horizon_s)`` and
    assemble the controller's :class:`~repro_torch.core.schedule.PlanSchedule`.

    Args:
        candidates: Candidate plan pool (shared (n_layers, n_experts)).
        topo: Sampled topology (scores use its per-slot graphs).
        activation: Expert-activation model for the scoring sweeps.
        workload: FLOP model for the scoring sweeps.
        compute: FLOPs -> seconds conversion.
        rng: Source of the shared scoring draws (consumed once).
        rcfg: Controller parameters.
        horizon_s: Wall-clock span the schedule must cover.
        slot_period_s: Seconds per topology slot.
        backlog_at: Optional ``f(boundary_k, t_s, current_candidate) ->
            (V,)`` live per-satellite backlog observation; ``None`` (and
            any mode but ``"backlog"``) scores on zero backlog.
        name: Schedule display name (default ``replan/<mode>``).
        device: Where the scoring sweeps run.

    Returns:
        The :class:`ReplanReport` with one decision per boundary walked.
        The walk is capped at one full slot cycle (n_slots - 1
        boundaries): a :class:`~repro_torch.core.schedule.PlanSchedule` is
        periodic in the slot index, so later boundaries replay the
        assignments already decided and a "decision" there could never
        be applied.
    """
    candidates = list(candidates)
    if not candidates:
        raise ValueError("empty candidate pool")
    bytes_per_expert = (rcfg.bytes_per_expert
                        if rcfg.bytes_per_expert is not None
                        else QueueConfig().migration_bytes_per_expert)
    n_slots = topo.n_slots
    batch = PlanBatch.from_plans(candidates, topo)
    # Shared draws: every boundary's sweep sees the same expert draws
    # (common random numbers), so score motion reflects the topology
    # slot and the backlog, not sampling noise.
    draws = np.stack([activation.sample(layer, rng, rcfg.n_tokens)
                      for layer in range(activation.n_layers)])

    def scores_at(slot: int, backlog: np.ndarray | None) -> np.ndarray:
        res = evaluate_plans(
            candidates, topo, activation, workload, compute, rng,
            n_tokens=rcfg.n_tokens, batch=batch,
            slots=np.full(rcfg.n_tokens, slot, dtype=np.int64), draws=draws,
            device=device)
        out = np.empty(len(candidates))
        for c, r in enumerate(res):
            base = r.mean_s if np.isfinite(r.mean_s) else rcfg.drop_penalty_s
            out[c] = base + r.drop_rate * rcfg.drop_penalty_s
            if backlog is not None:
                out[c] += backlog_penalty_s(candidates[c], backlog)
        return out

    slot_plan = np.full(n_slots, -1, dtype=np.int64)
    decisions: list[ReplanDecision] = []
    n_bounds = min(int(np.floor(max(horizon_s, 0.0) / slot_period_s)),
                   n_slots - 1)
    current = -1
    for k in range(n_bounds + 1):
        slot = k % n_slots
        decide = (k == 0
                  or (rcfg.mode != "off" and k % rcfg.period_slots == 0))
        if decide:
            backlog = None
            if rcfg.mode == "backlog" and backlog_at is not None and k > 0:
                backlog = backlog_at(k, k * slot_period_s, current)
            scores = scores_at(slot, backlog)
            best = int(np.argmin(scores))
            if current < 0:
                # Initial placement is free: no hysteresis, no migration.
                chosen, switched, mig_bytes = best, False, 0.0
            else:
                gain = scores[current] - scores[best]
                mig = migration_between(candidates[current],
                                        candidates[best],
                                        bytes_per_expert)
                gate = (rcfg.hysteresis * scores[current]
                        + mig.bytes_moved
                        * rcfg.migration_weight_s_per_mb / 1e6)
                switched = bool(best != current and gain > gate)
                chosen = best if switched else current
                mig_bytes = mig.bytes_moved if switched else 0.0
            decisions.append(ReplanDecision(
                boundary=k, slot=slot, chosen=chosen, switched=switched,
                scores=scores, migration_bytes=mig_bytes))
            current = chosen
        slot_plan[slot] = current
    slot_plan[slot_plan < 0] = current   # slots the horizon never reaches
    schedule = PlanSchedule(plans=candidates, slot_plan=slot_plan,
                            name=name or f"replan/{rcfg.mode}")
    return ReplanReport(schedule=schedule, decisions=decisions,
                        candidates=candidates)


def replan_base_scores(
    candidates: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    rcfg: ReplanConfig,
    device="cuda",
) -> np.ndarray:
    """Backlog-free candidate scores per topology slot, (n_slots, C).

    Exactly the ``scores_at(slot, backlog=None)`` table of
    :func:`build_replan_schedule` — zero-load mean latency plus the
    drop penalty, with the shared common-random-number draws consumed
    from ``rng`` once.  The joint control plane
    (``FleetSim.run_replan_grid``) precomputes this host-side and adds
    the backlog-inflation term on device, so the decide walk's scores
    match the host controller's bit for bit.
    """
    candidates = list(candidates)
    if not candidates:
        raise ValueError("empty candidate pool")
    batch = PlanBatch.from_plans(candidates, topo)
    draws = np.stack([activation.sample(layer, rng, rcfg.n_tokens)
                      for layer in range(activation.n_layers)])
    out = np.empty((topo.n_slots, len(candidates)))
    for slot in range(topo.n_slots):
        res = evaluate_plans(
            candidates, topo, activation, workload, compute, rng,
            n_tokens=rcfg.n_tokens, batch=batch,
            slots=np.full(rcfg.n_tokens, slot, dtype=np.int64),
            draws=draws, device=device)
        for c, r in enumerate(res):
            base = r.mean_s if np.isfinite(r.mean_s) else rcfg.drop_penalty_s
            out[slot, c] = base + r.drop_rate * rcfg.drop_penalty_s
    return out


@dataclasses.dataclass
class ReplanOutcome:
    """Probe -> decide -> evaluate, bundled.

    ``result`` holds C + 1 rows: every static candidate plus the
    controller's schedule (named ``replan/<mode>``), simulated in one
    fleet sweep under common random numbers — the apples-to-apples
    comparison the acceptance benchmarks plot.
    """

    report: ReplanReport
    result: TrafficResult
    probe: TrafficResult | None      # None unless mode == "backlog"
    sim: FleetSim

    @property
    def replanned(self):
        """The schedule row of ``result``."""
        return self.result.by_name(self.report.schedule.name)

    def best_static(self, key=lambda p: -p.goodput_tok_s):
        """The best static candidate row of ``result`` (default: by
        goodput)."""
        static = [p for p in self.result.plans
                  if p.plan_name != self.report.schedule.name]
        return min(static, key=key)


def replan_traffic(
    candidates: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    requests: RequestBatch,
    rng: np.random.Generator,
    rcfg: ReplanConfig,
    qcfg: QueueConfig,
    ground: GroundSegment | None = None,
    batching=None,
    **sim_kwargs,
) -> ReplanOutcome:
    """Close the re-placement loop over one request trace.

    ``batching`` (an optional
    :class:`~repro_torch.traffic.batching.BatchingConfig`) applies the
    continuous-batching service law to *every* fleet run of the loop —
    the probe row, each decide/evaluate round and the final evaluation —
    so the controller observes and is scored on the same batched
    queues; further keyword arguments (``service_model=``, ``probes=``,
    ...) forward to :class:`~repro_torch.traffic.queueing.FleetSim` the same
    way, ``device=`` among them (it also places the scoring sweeps).

    1. **Probe**: run the fleet with every candidate held static and
       record the (plan, satellite, bin) backlog — what a live
       controller would observe on the running system.
    2. **Decide**: walk the slot boundaries; at each decision the
       controller reads the backlog of the *currently chosen*
       candidate's probe row (the system it would actually be running)
       and re-ranks the pool.
    3. **Evaluate**: one fleet sweep of the static candidates plus the
       assembled schedule, migration bytes riding the ISL queues as
       background load.  With ``controller_iterations > 1`` the
       controller then re-observes the backlog of the *schedule's own*
       row — which carries the load its earlier switches left behind,
       invisible to any static probe row — re-decides, and re-evaluates
       (decide <-> observe fixed point, hysteresis-damped).

    All fleet runs share a seed, so engine draws and admission uniforms
    are common random numbers across every row of every round.
    """
    if rcfg.bytes_per_expert is None:
        # The gate must price exactly what the queues will bill.
        rcfg = dataclasses.replace(
            rcfg, bytes_per_expert=qcfg.migration_bytes_per_expert)
    if batching is not None:
        sim_kwargs = dict(sim_kwargs, batching=batching)
    device = sim_kwargs.get("device", "cuda")
    seed = int(rng.integers(0, 2**31 - 1))
    # The probe *construction* (engine pass) fixes the bin horizon the
    # decision walk must cover; only the backlog mode pays for the full
    # probe *run* — its observations are unread otherwise.
    probe_sim = FleetSim(candidates, topo, activation, workload, compute,
                         requests, np.random.default_rng(seed), qcfg=qcfg,
                         ground=ground, **sim_kwargs)
    probe_res = probe_sim.run() if rcfg.mode == "backlog" else None

    # Decide over the whole simulated horizon (arrivals + drain tail):
    # the fleet bills every boundary it crosses, so every billed switch
    # inside the first slot cycle should be a decided one.
    decision_span_s = probe_sim.n_bins * qcfg.dt_s

    def build(backlog_at):
        return build_replan_schedule(
            candidates, topo, activation, workload, compute,
            np.random.default_rng(seed + 1), rcfg,
            horizon_s=decision_span_s, slot_period_s=qcfg.slot_period_s,
            backlog_at=backlog_at if rcfg.mode == "backlog" else None,
            device=device)

    # Pin every decide<->observe round to one time-bin count (a genuinely
    # longer horizon still wins), as the reference does.
    eval_bins = {"n_bins": 0}

    def evaluate(schedule):
        sim = FleetSim(list(candidates) + [schedule], topo, activation,
                       workload, compute, requests,
                       np.random.default_rng(seed), qcfg=qcfg,
                       ground=ground, min_bins=eval_bins["n_bins"],
                       **sim_kwargs)
        eval_bins["n_bins"] = sim.n_bins
        return sim, sim.run()

    report = build(lambda _k, t_s, cur:
                   probe_sim.satellite_backlog(max(cur, 0), t_s))
    final_sim, result = evaluate(report.schedule)
    for _ in range(rcfg.controller_iterations - 1):
        if rcfg.mode != "backlog":
            break                        # nothing new to observe
        sched_row = len(candidates)      # the schedule's own fleet row
        next_report = build(lambda _k, t_s, _cur:
                            final_sim.satellite_backlog(sched_row, t_s))
        if np.array_equal(next_report.schedule.slot_plan,
                          report.schedule.slot_plan):
            report = next_report
            break                        # fixed point reached
        report = next_report
        final_sim, result = evaluate(report.schedule)
    return ReplanOutcome(report=report, result=result,
                         probe=probe_res, sim=final_sim)


def replan_traffic_fused(
    candidates: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    requests: RequestBatch,
    rng: np.random.Generator,
    rcfg: ReplanConfig,
    qcfg: QueueConfig,
    ground: GroundSegment | None = None,
    *,
    cadences=None,
    mig_weights=None,
    ttft_targets=None,
    tpot_targets=None,
    **sim_kwargs,
):
    """The joint control plane: :func:`replan_traffic` in one call.

    Same signature and seed discipline as the host loop (one
    ``rng.integers`` draw seeds the fleet, seed+1 seeds the scoring
    draws — common random numbers match round for round), but probe,
    decide walk and schedule evaluation run as one call of the joint
    control plane on the simulator's device (``queueing._ctrl_core``).
    The outcome's decisions, switch boundaries and served/shed sets
    reproduce :func:`replan_traffic` exactly; the host loop stays
    authoritative for continuous batching, probe rings and calibrated
    per-satellite service, which this path rejects.

    With any of ``cadences`` / ``mig_weights`` / ``ttft_targets`` given,
    the call becomes a controller *grid* — every cell batches the
    leading axis of the same single call — and returns one
    :class:`ReplanOutcome` per cell (cadence-major order).  Otherwise a
    single :class:`ReplanOutcome` is returned, with ``sim`` set to the
    probe simulator (the host loop's ``sim`` is its final evaluation
    simulator; the fused path never builds one).
    """
    if rcfg.bytes_per_expert is None:
        rcfg = dataclasses.replace(
            rcfg, bytes_per_expert=qcfg.migration_bytes_per_expert)
    seed = int(rng.integers(0, 2**31 - 1))
    sim = FleetSim(candidates, topo, activation, workload, compute,
                   requests, np.random.default_rng(seed), qcfg=qcfg,
                   ground=ground, **sim_kwargs)
    scores = replan_base_scores(candidates, topo, activation, workload,
                                compute, np.random.default_rng(seed + 1),
                                rcfg, device=sim.device)
    outcomes = sim.run_replan_grid(
        rcfg, base_scores=scores, cadences=cadences,
        mig_weights=mig_weights, ttft_targets=ttft_targets,
        tpot_targets=tpot_targets)
    if (cadences is None and mig_weights is None and ttft_targets is None
            and tpot_targets is None):
        return outcomes[0]
    return outcomes
