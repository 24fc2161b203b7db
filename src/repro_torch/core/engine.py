"""Batched plan-evaluation engine, in PyTorch on an explicit device.

Counterpart of ``repro.core.engine``: evaluates P placement plans (or Q
time-indexed schedules) x n tokens in one vectorized pass.  The
reference ``vmap``s over plans and ``lax.scan``s over layers; the layer
step carries nothing, so here it is one batched gather over
(Q, T, L, K): the distance-table gather, the Eq. 43 multi-expert
contention term and the route-staleness penalty as tensor ops.  The
per-slot Dijkstra distance table is the only host-side precompute
(scipy, bitwise the reference's); a :class:`PlanBatch` dedupes gateway
nodes across the whole sweep so it is built once per sweep.

Dtype policy is the reference's: the pass runs in float32 (the reference
engine runs without x64), and the per-token sum over layers is taken
layer by layer in order, the order XLA's CPU reduction uses, so on the
CPU the port reproduces the reference bit for bit.

Expert draws: with ``draws=`` / ``slots=`` pinned (what ``FleetSim`` and
the parity tests do) both packages see the same numbers.  Otherwise the
host stream of a numpy ``Generator`` is used exactly as the reference's
``sample_backend="host"``; ``sample_backend="torch"`` samples on the
device from an explicit ``torch.Generator`` (the counterpart of the
reference's on-device ``"jax"`` backend, with other random bits).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .activation import ActivationModel
from .calibration import ServiceModel, resolve_service_model
from .latency import (ComputeConfig, TopologySample, node_masks_from_sets,
                      source_distance_table)
from .placement import MultiExpertPlan, PlacementPlan
from .schedule import PlanSchedule, as_schedule
from .workload import MoEWorkload

# A stale route whose latency moved by more than one hop (> ~2 ms) — or
# that broke entirely — forces discovery + re-route.
HOP_SCALE_S = 2e-3


@dataclasses.dataclass
class SimResult:
    """Per-plan Monte-Carlo latency outcome of one engine pass.

    Attributes:
        token_latency_s: (n_tokens,) E2E latency per token — NaN where
            the token was undeliverable in its topology slot.
        layer_latency_s: (n_tokens, L) per-layer latency breakdown.
        plan_name: Name of the placement plan evaluated.
    """

    token_latency_s: np.ndarray
    layer_latency_s: np.ndarray
    plan_name: str

    @property
    def delivered(self) -> np.ndarray:
        """(n_tokens,) bool — token reached the user (finite latency)."""
        return np.isfinite(self.token_latency_s)

    @property
    def mean_s(self) -> float:
        """Mean latency over delivered tokens, seconds."""
        return float(np.nanmean(self.token_latency_s))

    @property
    def p99_s(self) -> float:
        """99th-percentile latency over delivered tokens, seconds."""
        return float(np.nanpercentile(self.token_latency_s, 99))

    @property
    def drop_rate(self) -> float:
        """Fraction of tokens that were undeliverable."""
        return float(1.0 - self.delivered.mean())


# --------------------------------------------------------------------- #
# Plan batching: stack P plans onto one deduped distance table
# --------------------------------------------------------------------- #


def _node_key(node_sets: list | None) -> tuple | None:
    """Canonical hashable form of a node_sets argument."""
    if node_sets is None:
        return None
    return tuple(tuple(sorted(int(n) for n in np.asarray(nodes).ravel()))
                 for nodes in node_sets)


def _topo_key(topo: TopologySample) -> tuple:
    """Cheap content fingerprint of a topology realization (a reused
    batch built on another realization would carry stale Dijkstra rows)."""
    return (topo.n_slots, topo.n_sats,
            hash(topo.edge_mask.tobytes()),
            hash(topo.edge_latency.tobytes()))


@dataclasses.dataclass
class PlanBatch:
    """P plans stacked for one engine pass over a shared distance table.

    ``dist`` holds rows for the *unique* (gateway, routing-mask) pairs of
    the sweep; ``g_idx[p, l]`` maps plan p / layer l to its row.
    """

    dist: np.ndarray          # (N_T, G, V) shared shortest-path table
    g_idx: np.ndarray         # (P, L) row of dist for plan p, layer l
    gateways: np.ndarray      # (P, L) raw gateway node indices
    expert_sats: np.ndarray   # (P, L, I) satellite hosting expert i
    eta: np.ndarray           # (P,) contention efficiency (1.0 = single-expert)
    names: tuple[str, ...]
    node_key: tuple | None
    topo_key: tuple
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_plans(self) -> int:
        """Number of plans stacked in the batch (P)."""
        return self.g_idx.shape[0]

    @property
    def n_layers(self) -> int:
        """Number of MoE layers shared by every plan (L)."""
        return self.g_idx.shape[1]

    def device_arrays(self, device: torch.device) -> tuple:
        """(dist f32, g_idx, expert_sats, eta f32) on ``device``, cached
        per device so the O(N_T*G*V) transfer happens once per batch."""
        key = str(device)
        if key not in self._device:
            self._device[key] = (
                torch.from_numpy(self.dist.astype(np.float32)).to(device),
                torch.from_numpy(np.asarray(self.g_idx, np.int64)).to(device),
                torch.from_numpy(np.asarray(self.expert_sats,
                                            np.int64)).to(device),
                torch.from_numpy(self.eta.astype(np.float32)).to(device),
            )
        return self._device[key]

    def matches(self, plans: list, topo: TopologySample,
                node_sets: list | None, eta: float) -> bool:
        """True iff this batch was built from exactly these plans, this
        topology realization and these settings."""
        gws = np.stack([np.asarray(p.gateways) for p in plans])
        sats = np.stack([np.asarray(p.expert_sats) for p in plans])
        etas = np.array(
            [eta if isinstance(p, MultiExpertPlan) else 1.0 for p in plans])
        return (gws.shape == self.gateways.shape
                and np.array_equal(gws, self.gateways)
                and sats.shape == self.expert_sats.shape
                and np.array_equal(sats, self.expert_sats)
                and np.array_equal(etas, self.eta)
                and _node_key(node_sets) == self.node_key
                and _topo_key(topo) == self.topo_key)

    @classmethod
    def from_plans(
        cls,
        plans: list[PlacementPlan | MultiExpertPlan],
        topo: TopologySample,
        node_sets: list | None = None,
        eta: float = 1.0,
    ) -> "PlanBatch":
        """Stack plans and build the deduped Dijkstra table.

        ``eta`` is the Eq. 43 compute-sharing efficiency, applied to
        :class:`MultiExpertPlan` entries only.
        """
        plans = list(plans)
        if not plans:
            raise ValueError("empty plan sweep")
        n_layers = len(plans[0].gateways)
        masks: list | None = None
        if node_sets is not None:
            masks = node_masks_from_sets(node_sets, topo.n_sats)

        # Dedupe (gateway node, per-layer mask) -> distance-table row.
        row_of: dict[tuple, int] = {}
        sources: list[int] = []
        row_masks: list = []
        g_idx = np.empty((len(plans), n_layers), dtype=np.int64)
        for pi, plan in enumerate(plans):
            if len(plan.gateways) != n_layers:
                raise ValueError("all plans in a sweep must share n_layers")
            for layer, g in enumerate(np.asarray(plan.gateways)):
                key = (int(g), layer if masks is not None else -1)
                if key not in row_of:
                    row_of[key] = len(sources)
                    sources.append(int(g))
                    row_masks.append(masks[layer] if masks is not None else None)
                g_idx[pi, layer] = row_of[key]
        dist = source_distance_table(
            topo, np.asarray(sources, dtype=np.int64),
            row_masks if masks is not None else None,
        )
        gateways = np.stack([np.asarray(p.gateways) for p in plans])
        expert_sats = np.stack([np.asarray(p.expert_sats) for p in plans])
        etas = np.array(
            [eta if isinstance(p, MultiExpertPlan) else 1.0 for p in plans],
            dtype=np.float64,
        )
        names = tuple(getattr(p, "name", "plan") for p in plans)
        return cls(dist=dist, g_idx=g_idx, gateways=gateways,
                   expert_sats=expert_sats, eta=etas, names=names,
                   node_key=_node_key(node_sets), topo_key=_topo_key(topo))


# --------------------------------------------------------------------- #
# Schedule batching: Q time-indexed schedules over one union PlanBatch
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class ScheduleBatch:
    """Q :class:`~repro_torch.core.schedule.PlanSchedule` entries stacked
    for one engine pass: the union of every schedule's plans in one
    :class:`PlanBatch`, and ``plan_row[q, n]`` the union row of schedule q
    in topology slot n."""

    base: PlanBatch           # union-plan batch (deduped Dijkstra table)
    plan_row: np.ndarray      # (Q, N_T) base-batch row per (schedule, slot)
    names: tuple[str, ...]

    @property
    def n_schedules(self) -> int:
        """Number of schedules stacked in the batch (Q)."""
        return self.plan_row.shape[0]

    @property
    def n_layers(self) -> int:
        """MoE layers shared by every plan of every schedule (L)."""
        return self.base.n_layers

    @property
    def n_sats(self) -> int:
        """Graph nodes of the topology the batch was built on (V)."""
        return self.base.dist.shape[2]

    def gateways_by_slot(self) -> np.ndarray:
        """(Q, N_T, L) gateway satellite per (schedule, slot, layer)."""
        return self.base.gateways[self.plan_row]

    def expert_sats_by_slot(self) -> np.ndarray:
        """(Q, N_T, L, I) expert satellite per (schedule, slot, layer,
        expert)."""
        return self.base.expert_sats[self.plan_row]

    def eta_by_slot(self) -> np.ndarray:
        """(Q, N_T) Eq. 43 compute-sharing efficiency per (schedule,
        slot)."""
        return self.base.eta[self.plan_row]

    def matches(self, schedules: list, topo: TopologySample,
                node_sets: list | None, eta: float) -> bool:
        """True iff this batch was built from exactly these schedules on
        this topology realization and these settings."""
        union = [p for s in schedules for p in s.plans]
        if len(union) != self.base.n_plans:
            return False
        rows = _schedule_rows(schedules)
        return (rows.shape == self.plan_row.shape
                and np.array_equal(rows, self.plan_row)
                and self.base.matches(union, topo, node_sets, eta))

    @classmethod
    def from_schedules(
        cls,
        schedules: list[PlanSchedule],
        topo: TopologySample,
        node_sets: list | None = None,
        eta: float = 1.0,
    ) -> "ScheduleBatch":
        """Stack schedules onto one union :class:`PlanBatch`."""
        schedules = list(schedules)
        if not schedules:
            raise ValueError("empty schedule sweep")
        for s in schedules:
            if s.n_slots != topo.n_slots:
                raise ValueError(
                    f"schedule {s.name!r} covers {s.n_slots} slots but the "
                    f"topology has {topo.n_slots}")
        union = [p for s in schedules for p in s.plans]
        base = PlanBatch.from_plans(union, topo, node_sets=node_sets, eta=eta)
        return cls(base=base, plan_row=_schedule_rows(schedules),
                   names=tuple(s.name for s in schedules))


def _schedule_rows(schedules: list[PlanSchedule]) -> np.ndarray:
    """(Q, N_T) union-batch row per (schedule, slot)."""
    offsets = np.cumsum([0] + [len(s.plans) for s in schedules[:-1]])
    return np.stack([off + s.slot_plan
                     for off, s in zip(offsets, schedules)])


def schedule_ingress_offsets(batch: ScheduleBatch, slots: np.ndarray,
                             ingress_sats: np.ndarray) -> np.ndarray:
    """Per-token uphill offset D(ingress sat, gateway_0; slot), shape
    (Q, T), with the layer-0 gateway row following the slot's plan."""
    slots = np.asarray(slots)
    ingress_sats = np.asarray(ingress_sats)
    g0 = batch.base.g_idx[batch.plan_row[:, slots], 0]        # (Q, T)
    return batch.base.dist[slots[None, :], g0, ingress_sats[None, :]]


def eq43_layer_terms(batch: ScheduleBatch, sched: int, slots: np.ndarray,
                     draws: np.ndarray, t_gateway: float,
                     t_expert: float = 0.0,
                     expert_sec: np.ndarray | None = None,
                     inv_speed: np.ndarray | None = None) -> dict:
    """Per-(token, layer, branch) decomposition of the Eq. 43 layer cost
    (host numpy, the reference's function): the engine's indexing with
    current-slot paths, so the flight recorder can split a token's
    zero-load layer latency into outbound hop, expert service under
    colocation contention and return hop.

    Args:
        batch: The :class:`ScheduleBatch` the run evaluated.
        sched: Schedule row q to decompose.
        slots: (T,) topology slot per token.
        draws: (L, T, K) expert draws.
        t_gateway: Gateway service seconds per layer.
        t_expert: Analytic per-expert service seconds (used when the
            calibrated tables below are absent).
        expert_sec: Optional (I,) calibrated per-expert service seconds.
        inv_speed: Optional (V,) per-satellite inverse speed factors
            (both given => the calibrated Eq. 43 service term).

    Returns:
        Dict of arrays: ``d_out``/``d_in``/``t_exp`` (T, L, K) seconds,
        ``q`` (T, L, K) colocation counts, ``sats`` (T, L, K) serving
        satellites, and ``layer_s`` (T, L) — ``t_gateway + max_K(d_out +
        t_exp + d_in)`` with unreachable branches as NaN.
    """
    base = batch.base
    slots = np.asarray(slots)
    rows = np.asarray(batch.plan_row)[int(sched), slots]        # (T,)
    g_tok = np.asarray(base.g_idx)[rows]                        # (T, L)
    g_next = np.roll(g_tok, -1, axis=1)   # ring wrap for the last layer
    eta_tok = np.asarray(base.eta)[rows]                        # (T,)
    draws_tlk = np.moveaxis(np.asarray(draws), 0, 1)            # (T, L, K)
    sats = np.take_along_axis(np.asarray(base.expert_sats)[rows],
                              draws_tlk, axis=2)                # (T, L, K)
    dist = np.asarray(base.dist)
    s3 = slots[:, None, None]
    d_out = dist[s3, g_tok[:, :, None], sats]
    d_in = dist[s3, g_next[:, :, None], sats]
    q = (sats[..., :, None] == sats[..., None, :]).sum(axis=-1)
    if expert_sec is not None and inv_speed is not None:
        unit = np.asarray(expert_sec)[draws_tlk] \
            * np.asarray(inv_speed)[sats]
    else:
        unit = t_expert
    t_exp = (np.asarray(q, dtype=dist.dtype)
             / eta_tok[:, None, None]) * unit
    layer = t_gateway + (d_out + t_exp + d_in).max(axis=2)      # (T, L)
    layer = np.where(np.isfinite(layer), layer, np.nan)
    return dict(d_out=d_out, d_in=d_in, q=q, t_exp=t_exp, sats=sats,
                layer_s=layer)


# --------------------------------------------------------------------- #
# The batched pass
# --------------------------------------------------------------------- #


def contention_counts(sats: torch.Tensor) -> torch.Tensor:
    """q[..., k] = number of activated experts sharing satellite
    ``sats[..., k]`` (the Eq. 43 colocation count; last axis = top-K)."""
    return (sats[..., :, None] == sats[..., None, :]).sum(dim=-1)


def hop_latency(dist, slots, stale_slots, g, sats, penalty, stale: bool):
    """Gateway<->expert hop latencies with the staleness penalty.

    ``slots``/``stale_slots`` broadcast against ``g`` and ``sats``.  With
    ``stale`` the path was chosen on the topology ``stale_slots`` ago: a
    topology change (detour > ~one hop, or a broken route) pays the
    current shortest path plus ``penalty``.
    """
    cur = dist[slots, g, sats]
    if not stale:
        return cur
    old = dist[stale_slots, g, sats]
    broken = ((old - cur).abs() > HOP_SCALE_S) | ~torch.isfinite(old)
    return cur + penalty * broken


def _layer_latency(dist, g_idx, expert_sats, eta, row_tok, slots,
                   stale_slots, draws, t_gateway, t_expert, t_head, penalty,
                   expert_sec, inv_speed, stale, calibrated):
    """(token_latency (Q, T), layer_latency (Q, T, L)), float32.

    dist: (N_T, G, V); g_idx: (P, L); expert_sats: (P, L, I); eta: (P,);
    row_tok: (Q, T) union-batch row per token; slots/stale_slots: (T,);
    draws: (L, T, K).  Every tensor on one device.
    """
    g_tok = g_idx[row_tok]                                    # (Q, T, L)
    g_next = torch.roll(g_tok, -1, dims=2)   # ring wrap for the last layer
    eta_tok = eta[row_tok][:, :, None, None]                  # (Q, T, 1, 1)
    d_tlk = draws.permute(1, 0, 2)                            # (T, L, K)
    sats_tok = expert_sats[row_tok]                           # (Q, T, L, I)
    sats = torch.gather(sats_tok, 3, d_tlk[None].expand(
        sats_tok.shape[:3] + d_tlk.shape[2:]))                # (Q, T, L, K)
    s4, st4 = slots[None, :, None, None], stale_slots[None, :, None, None]
    d_out = hop_latency(dist, s4, st4, g_tok[..., None], sats, penalty, stale)
    d_in = hop_latency(dist, s4, st4, g_next[..., None], sats, penalty, stale)
    q = contention_counts(sats).to(dist.dtype)
    if calibrated:
        unit = expert_sec[d_tlk][None] * inv_speed[sats]      # (Q, T, L, K)
        t_exp = (q / eta_tok) * unit
    else:
        t_exp = (q / eta_tok) * t_expert
    layer = (d_out + t_exp + d_in).amax(dim=3) + t_gateway    # (Q, T, L)
    # Unreachable satellite in that slot => undeliverable token (NaN).
    layer = torch.where(torch.isfinite(layer), layer,
                        torch.full_like(layer, float("nan")))
    token = layer[..., 0]
    for lay in range(1, layer.shape[2]):      # in order, as XLA's reduce
        token = token + layer[..., lay]
    return token + t_head, layer


def _service_terms(svc: ServiceModel, topo, ctx_len, include_lm_head,
                   device):
    """Service constants + calibrated arrays (float32) for one pass."""
    t_gateway = svc.gateway_s(ctx_len)
    t_head = svc.head_s if include_lm_head else 0.0
    if svc.per_satellite:
        t_expert = 0.0
        expert_sec = torch.from_numpy(
            np.asarray(svc.expert_s(), np.float32)).to(device)
        inv_speed = torch.from_numpy(
            np.asarray(svc.inv_speed(topo.n_sats), np.float32)).to(device)
    else:
        t_expert = svc.expert_scalar
        expert_sec = inv_speed = None
    return t_gateway, t_expert, t_head, expert_sec, inv_speed


def sample_draws_torch(activation: ActivationModel, n_tokens: int,
                       generator: torch.Generator,
                       device: torch.device) -> torch.Tensor:
    """(L, T, K) conditional-Poisson draws on ``device`` from ``generator``.

    The sequential ESP-ratio method of
    :func:`~repro_torch.core.activation.sample_topk`, vectorized over
    layers and draws (float32, like the reference's on-device sampler).
    """
    w = torch.as_tensor(activation.weights, dtype=torch.float32,
                        device=device)                        # (L, I)
    n_layers, n = w.shape
    k = activation.top_k
    ws = w / w.mean(dim=1, keepdim=True)
    table = torch.zeros(n_layers, n + 1, k + 1, device=device)
    table[:, 0, 0] = 1.0
    for i in range(1, n + 1):
        table[:, i] = table[:, i - 1]
        table[:, i, 1:] += ws[:, i - 1, None] * table[:, i - 1, :-1]
    u = torch.rand((n_layers, n, n_tokens), generator=generator,
                   device=device)
    remaining = torch.full((n_layers, n_tokens), k, dtype=torch.int64,
                           device=device)
    out = torch.zeros((n_layers, n_tokens, k), dtype=torch.int64,
                      device=device)
    lidx = torch.arange(n_layers, device=device)[:, None]
    slot = torch.arange(k, device=device)
    for i in range(n, 0, -1):
        num = ws[:, i - 1, None] * table[lidx, i - 1,
                                         (remaining - 1).clamp(min=0)]
        den = table[lidx, i, remaining]
        p = torch.where(remaining > 0, num / den, torch.zeros_like(num))
        take = u[:, n - i] < p
        write = take[..., None] & (slot == (remaining - 1)[..., None])
        out = torch.where(write, i - 1, out)
        remaining = remaining - take.to(torch.int64)
    return out


def _resolve_slots_draws(topo, activation, rng, n_tokens, slots, draws,
                         sample_backend, generator, device):
    """The token -> slot assignment and the (L, T, K) expert draws, with
    the reference's host random stream when neither is pinned."""
    n_layers = activation.n_layers
    if slots is None:
        slots = rng.integers(0, topo.n_slots, size=n_tokens)
    else:
        slots = np.asarray(slots)
        if slots.shape != (n_tokens,):
            raise ValueError("slots must have shape (n_tokens,)")
        if slots.min() < 0 or slots.max() >= topo.n_slots:
            raise ValueError("slot index out of range for this topology")
    if draws is not None:
        draws = np.asarray(draws)
        if draws.shape != (n_layers, n_tokens, activation.top_k):
            raise ValueError("draws must have shape (n_layers, n_tokens, K)")
        return slots, torch.from_numpy(draws.astype(np.int64)).to(device)
    if sample_backend == "host":
        # Same call order as the reference: slots, then layer draws.
        draws = np.stack([activation.sample(layer, rng, n_tokens)
                          for layer in range(n_layers)])
        return slots, torch.from_numpy(draws.astype(np.int64)).to(device)
    if sample_backend == "torch":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(
                int(rng.integers(0, 2**31 - 1)))
        return slots, sample_draws_torch(activation, n_tokens, generator,
                                         device)
    raise ValueError(f"unknown sample_backend {sample_backend!r}")


def _run_pass(batch: PlanBatch, plan_row, topo, activation, workload,
              compute, rng, n_tokens, ctx_len, include_lm_head,
              route_staleness, reroute_penalty_s, sample_backend, slots,
              draws, service_model, generator, device):
    dev = resolve_device(device)
    slots, draws_t = _resolve_slots_draws(
        topo, activation, rng, n_tokens, slots, draws, sample_backend,
        generator, dev)
    stale_slots = (slots - route_staleness) % topo.n_slots
    svc = resolve_service_model(service_model, workload, compute)
    t_gateway, t_expert, t_head, expert_sec, inv_speed = _service_terms(
        svc, topo, ctx_len, include_lm_head, dev)
    dist, g_idx, sats, eta = batch.device_arrays(dev)
    slots_t = torch.from_numpy(np.asarray(slots, np.int64)).to(dev)
    stale_t = torch.from_numpy(np.asarray(stale_slots, np.int64)).to(dev)
    row_tok = torch.from_numpy(np.array(plan_row, np.int64)).to(dev)[
        :, slots_t]                                           # (Q, T)
    token_lat, layer_lat = _layer_latency(
        dist, g_idx, sats, eta, row_tok, slots_t, stale_t, draws_t,
        t_gateway, t_expert, t_head, reroute_penalty_s, expert_sec,
        inv_speed, stale=route_staleness != 0, calibrated=svc.per_satellite)
    return (token_lat.cpu().numpy().astype(np.float64),
            layer_lat.cpu().numpy().astype(np.float64))


# --------------------------------------------------------------------- #
# Public sweep API
# --------------------------------------------------------------------- #


def evaluate_plans(
    plans: list[PlacementPlan | MultiExpertPlan],
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    n_tokens: int = 1000,
    ctx_len: int = 1024,
    include_lm_head: bool = True,
    eta: float = 1.0,
    node_sets: list | None = None,
    route_staleness: int = 0,
    reroute_penalty_s: float = 0.0,
    batch: PlanBatch | None = None,
    sample_backend: str = "host",
    slots: np.ndarray | None = None,
    draws: np.ndarray | None = None,
    service_model: ServiceModel | str | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> list[SimResult]:
    """Monte-Carlo E2E latency for a sweep of P plans, one batched pass.

    The arguments are ``repro.core.engine.evaluate_plans``'s, plus
    ``device`` (where the pass runs; CUDA unless the caller asks for the
    CPU) and ``generator`` (the ``torch.Generator`` of
    ``sample_backend="torch"``).  All plans share the same token draws
    and slot samples (common random numbers).
    """
    plans = list(plans)
    if batch is None:
        batch = PlanBatch.from_plans(plans, topo, node_sets=node_sets, eta=eta)
    if batch.n_plans != len(plans):
        raise ValueError("batch/plans length mismatch")
    if not batch.matches(plans, topo, node_sets, eta):
        raise ValueError(
            "prebuilt batch was built from a different sweep (plan "
            "placements, topology realization, node_sets or eta disagree) "
            "— rebuild it with PlanBatch.from_plans")
    if batch.n_layers != activation.n_layers:
        raise ValueError("plan sweep and activation model disagree on n_layers")
    identity = np.broadcast_to(np.arange(batch.n_plans)[:, None],
                               (batch.n_plans, topo.n_slots))
    token_lat, layer_lat = _run_pass(
        batch, identity, topo, activation, workload, compute, rng, n_tokens,
        ctx_len, include_lm_head, route_staleness, reroute_penalty_s,
        sample_backend, slots, draws, service_model, generator, device)
    return [SimResult(token_latency_s=token_lat[p],
                      layer_latency_s=layer_lat[p], plan_name=batch.names[p])
            for p in range(batch.n_plans)]


def evaluate_schedules(
    schedules: list,
    topo: TopologySample,
    activation: ActivationModel,
    workload: MoEWorkload,
    compute: ComputeConfig,
    rng: np.random.Generator,
    n_tokens: int = 1000,
    ctx_len: int = 1024,
    include_lm_head: bool = True,
    eta: float = 1.0,
    node_sets: list | None = None,
    route_staleness: int = 0,
    reroute_penalty_s: float = 0.0,
    batch: ScheduleBatch | None = None,
    sample_backend: str = "host",
    slots: np.ndarray | None = None,
    draws: np.ndarray | None = None,
    service_model: ServiceModel | str | None = None,
    generator: torch.Generator | None = None,
    device="cuda",
) -> list[SimResult]:
    """Monte-Carlo E2E latency for a sweep of Q time-indexed schedules.

    The time-indexed face of :func:`evaluate_plans`: per token the
    topology slot selects the plan in effect (the ``plan_row`` gather of
    :class:`ScheduleBatch`).  Plain plans are wrapped into constant
    schedules, which reproduce :func:`evaluate_plans` bit for bit.
    """
    schedules = [as_schedule(s, topo.n_slots) for s in schedules]
    if batch is None:
        batch = ScheduleBatch.from_schedules(schedules, topo,
                                             node_sets=node_sets, eta=eta)
    if batch.n_schedules != len(schedules):
        raise ValueError("batch/schedules length mismatch")
    if not batch.matches(schedules, topo, node_sets, eta):
        raise ValueError(
            "prebuilt batch was built from a different sweep (schedule "
            "plans, slot maps, topology realization, node_sets or eta "
            "disagree) — rebuild it with ScheduleBatch.from_schedules")
    if batch.n_layers != activation.n_layers:
        raise ValueError("schedule sweep and activation model disagree on "
                         "n_layers")
    token_lat, layer_lat = _run_pass(
        batch.base, batch.plan_row, topo, activation, workload, compute, rng,
        n_tokens, ctx_len, include_lm_head, route_staleness,
        reroute_penalty_s, sample_backend, slots, draws, service_model,
        generator, device)
    return [SimResult(token_latency_s=token_lat[q],
                      layer_latency_s=layer_lat[q], plan_name=batch.names[q])
            for q in range(batch.n_schedules)]
