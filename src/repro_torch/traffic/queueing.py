"""Discrete-time per-satellite service model for request-level serving.

Counterpart of ``repro.traffic.queueing``.  Every satellite is a FIFO
work queue; a token deposits on the L gateway satellites and the
per-layer expert satellites of the plan its topology slot selects, and
the simulator iterates a closed-loop fixed point

    schedule -> bin (deposit) -> backlog scan -> gather

``QueueConfig.iterations`` times (iteration 1 is the open-loop
approximation; later ones let congested tokens arrive after the backlog
they caused).  Deposits larger than one bin of service are spread over
consecutive bins (chunked prefill).

Two execution paths share the construction-time precompute, as in the
reference:

* the **fused path** (``run`` / ``run_many``): the whole fixed point as
  tensor code on the simulator's device (:func:`_fleet_fixed_point`),
  batched over a sweep axis F.  Schedules, bins and deposits compute in
  float64; the backlog scan runs in float32 (the reference's downcast).
  On a CUDA device the deposit is ``kernels.deposit`` (CUDA, bitwise the
  f64 scatter-add) and the scan ``kernels.backlog_scan``; on the CPU
  both run their plain versions.
* the **host path** (``run_legacy``): the reference's NumPy loop, with
  only the backlog scan on the device — the semantic anchor the fused
  path is held to.

Not ported yet (each raises ``NotImplementedError``): the ground segment
(``ground=``), the AIMD/PID admission controller, continuous batching
(``batching=``), the telemetry probes (``probes=``) and the joint
re-placement control plane (``run(replan=...)``).  The reference's jit
and compile-cache machinery has no counterpart here: PyTorch runs
eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.activation import ActivationModel
from ..core.calibration import resolve_service_model
from ..core.engine import ScheduleBatch, evaluate_schedules
from ..core.latency import ComputeConfig, TopologySample
from ..core.schedule import as_schedule, slot_of_time
from ..core.workload import MoEWorkload
from ..kernels.backlog_scan import backlog_scan
from ..kernels.deposit import deposit
from .metrics import PlanTraffic, TrafficResult
from .requests import RequestBatch


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (it comes with the "
        f"{slice_} slice of the port); use the reference repro.traffic")


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """Discrete-time queueing parameters (the reference's fields).

    Attributes:
        dt_s: Time-bin width.
        buffer_s: Per-station backlog cap in seconds of work; arrivals
            overflowing it are dropped (backpressure).
        kv_slots: Max requests concurrently holding KV cache (0 = no cap).
        slot_period_s: Wall-clock seconds per topology slot.
        tail_s: Extra horizon past the last zero-load completion.
        iterations: Schedule<->queue fixed-point iterations (1 = open
            loop).
        admission: The reference's ``AdmissionConfig``; a policy of
            ``"aimd"`` or ``"pid"`` is not ported yet (raises).
        migration_bytes_per_expert: Weight bytes one expert drags to a new
            satellite when a plan schedule switches plans.
        migration_rate_gbps: ISL share available to weight migration.
    """

    dt_s: float = 0.05
    buffer_s: float = 10.0
    kv_slots: int = 0
    slot_period_s: float = 300.0
    tail_s: float = 120.0
    iterations: int = 3
    admission: object | None = None
    migration_bytes_per_expert: float = 1e6
    migration_rate_gbps: float = 10.0


# --------------------------------------------------------------------- #
# The fleet queue scan (host-path anchor)
# --------------------------------------------------------------------- #


def _fleet_queue_scan(work: torch.Tensor, cap: float, dt: float):
    """Scan the (P, S) backlog matrix over T time bins, float32.

    work: (P, S, T) seconds of work arriving per bin (downcast to f32 as
    the reference's scan does).  Returns (wait, dropped), both (P, S, T):
    ``wait[..., t]`` is the backlog an arrival in bin t finds;
    ``dropped`` the overflow discarded per bin.
    """
    p, s, t = work.shape
    w32 = work.to(torch.float32)
    wait_t = backlog_scan(w32.permute(2, 0, 1).reshape(t, p * s), cap, dt)
    wait = wait_t.reshape(t, p, s).permute(1, 2, 0)
    cap32 = torch.tensor(cap, dtype=torch.float32, device=work.device)
    dropped = torch.clamp_min((wait + w32) - cap32, 0.0)
    return wait, dropped


def station_waiting_times(
    arrival_s: np.ndarray,
    service_s: np.ndarray | float,
    dt_s: float,
    buffer_s: float = np.inf,
    horizon_s: float | None = None,
    batching=None,
    device="cuda",
) -> np.ndarray:
    """Per-arrival waiting times at one FIFO station via the fleet scan,
    refined with the exact within-bin Lindley correction (the reference's
    single-station M/D/1 check).  ``batching`` is not ported yet."""
    if batching is not None:
        raise _not_ported("station_waiting_times(batching=...)", "batching")
    t = np.asarray(arrival_s, dtype=np.float64)
    if len(t) and not (np.diff(t) >= 0).all():
        raise ValueError("arrivals must be sorted")
    s = np.broadcast_to(np.asarray(service_s, dtype=np.float64), t.shape)
    horizon = (float(t[-1]) if len(t) else 0.0) \
        if horizon_s is None else horizon_s
    n_bins = int(np.floor(horizon / dt_s)) + 2
    bins = np.minimum((t / dt_s).astype(np.int64), n_bins - 1)
    work = np.bincount(bins, weights=s, minlength=n_bins)
    dev = resolve_device(device)
    wait_bins = _fleet_queue_scan(
        torch.from_numpy(work[None, None, :]).to(dev), float(buffer_s),
        dt_s)[0][0, 0].cpu().numpy()
    cs = np.cumsum(s)
    first = np.searchsorted(bins, bins, side="left")
    prior = (cs - s) - (cs[first] - s[first])
    delta = t - bins * dt_s
    return np.maximum(wait_bins[bins] + prior - delta, 0.0)


# --------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------- #


def _exclusive_cumsum(a: np.ndarray, axis: int) -> np.ndarray:
    out = np.cumsum(a, axis=axis)
    return out - a


def _segment_any(flags: np.ndarray, seg_ids: np.ndarray,
                 n_seg: int) -> np.ndarray:
    """OR-reduce boolean ``flags`` (P, E) over segments of the last axis."""
    p, _ = flags.shape
    idx = np.arange(p)[:, None] * n_seg + seg_ids[None, :]
    hits = np.bincount(idx.ravel(), weights=flags.ravel().astype(np.float64),
                       minlength=p * n_seg)
    return hits.reshape(p, n_seg) > 0.0


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (XLA's CPU reduction order),
    so the sum is the same on every device."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


# --------------------------------------------------------------------- #
# The fused fixed point
# --------------------------------------------------------------------- #

#: The compacted chunk table is padded to a multiple of this (the
#: reference's compile-cache block; kept so the tables match it).
_CHUNK_BLOCK = 8192


def _fleet_fixed_point(q: dict, chunks: dict, work0: torch.Tensor,
                       work0_sum: torch.Tensor, n_iter: int, n_bins: int,
                       n_rows: int, want_wait: bool) -> dict:
    """The fused fixed point of ``FleetSim.run``, over a sweep axis F.

    The reference's ``_fleet_fixed_point`` with admission, batching and
    probes off: every tensor lives on one device; schedules, bins and
    deposits in float64, the work plane time-major ``(T, F, rows)`` for
    the float32 backlog scan.  The first iteration is peeled: its
    zero-wait schedule is static, so its work plane ``work0`` (F, rows,
    T) float32 and per-row sums ``work0_sum`` arrive precomputed, and
    the deposit runs for iterations 2..n only.

    Args:
        q: Device tables (:meth:`FleetSim._device_tables`).
        chunks: Compacted deposit table: ``src`` (gather index into the
            F-flattened [layer_arr | exp_arr] pair), ``offs`` (chunk
            offset in bins), ``work`` (seconds), ``fprow`` (row of the
            (F * rows) plane) and ``row_ptr`` (the table's row grouping,
            see ``kernels.deposit``).
        work0: (F, rows, T) float32 iteration-1 offered work.
        work0_sum: (F, rows) float64 per-row sum of iteration-1 work.
        n_iter: Fixed-point iterations.
        n_bins: T, the time-bin count.
        n_rows: Compacted queue-row count.
        want_wait: Also return the final (T, F, rows) backlog trace.

    Returns:
        Dict with a leading F axis: ``ttft``/``e2e`` (F, P, R),
        ``tok_total`` (F, P, M), ``tok_over`` (F, P, M) bool,
        ``work_sum`` (F, rows), and iff ``want_wait`` ``wait``.
    """
    first_tok, tok_req = q["first_tok"], q["tok_req"]
    F = work0.shape[0]
    R = first_tok.shape[0]
    P, M, L = q["eff_layer"].shape
    T, SR = n_bins, n_rows
    dt, cap = q["dt"], q["cap"]
    f64 = torch.float64

    def to_bins(times):
        finite = torch.isfinite(times)
        b = (torch.where(finite, times, 0.0) / dt).to(torch.int64) \
            .clamp(0, T - 1)
        return torch.where(finite, b, 0), finite

    def schedule(gw_wait, ex_max, start_pref):
        lay_cost = q["eff_layer"][None] + gw_wait + ex_max
        tok_total = q["tok_base"][None] + _seq_sum(gw_wait) + _seq_sum(ex_max)
        dec = tok_total[:, :, R:]
        cs = torch.cumsum(dec, dim=2)
        excl = cs - dec
        base = excl[:, :, first_tok][:, :, tok_req]
        c0 = start_pref + tok_total[:, :, :R]
        start_dec = c0[:, :, tok_req] + (excl - base)
        start_all = torch.cat([start_pref, start_dec], dim=2)
        layer_arr = start_all[..., None] \
            + (torch.cumsum(lay_cost, dim=3) - lay_cost)
        exp_arr = layer_arr + gw_wait + q["gw_service"][None, None, :, None]
        return layer_arr, exp_arr, tok_total, cs - base

    def bin_work(layer_arr, exp_arr):
        flat_t = torch.cat([layer_arr.reshape(F, -1),
                            exp_arr.reshape(F, -1)], dim=1).reshape(-1)
        b_ch, fin = to_bins(flat_t[chunks["src"]])
        bins = torch.clamp_max(b_ch + chunks["offs"], T - 1)
        vals = chunks["work"] * fin
        work = deposit(chunks["fprow"], bins, vals, F * SR, T,
                       row_ptr=chunks["row_ptr"]).reshape(F, SR, T)
        if "mig_dense" in q:
            work = work + q["mig_dense"][None]
        return work

    def gather(wait_t, work32, gw_b, gw_fin, ex_b, ex_fin):
        f_idx = torch.arange(F, device=work32.device)[:, None, None, None]
        gw_rows, ex_rows = q["gw_rows"][None], q["ex_rows"][None]
        w_g = wait_t[gw_b, f_idx, gw_rows]
        gw_wait = torch.where(gw_fin, w_g, 0.0).to(f64)
        gw_over = gw_fin & ((w_g + work32[f_idx, gw_rows, gw_b]) > cap)
        ex_b5, ex_f5 = ex_b[..., None], ex_fin[..., None]
        f_idx5 = f_idx[..., None]
        w_e = wait_t[ex_b5, f_idx5, ex_rows]
        ex_wait = torch.where(ex_f5, w_e, 0.0).to(f64)
        ex_over = ex_f5 & ((w_e + work32[f_idx5, ex_rows, ex_b5]) > cap)
        return gw_wait, ex_wait.amax(dim=4), gw_over, ex_over.any(dim=4)

    def finish_iter(work32, work_sum, gw_b, gw_fin, ex_b, ex_fin):
        work32_t = work32.permute(2, 0, 1).reshape(T, F * SR)
        wait_t = backlog_scan(work32_t, q["cap32"], q["dt32"]) \
            .reshape(T, F, SR)
        gw_wait, ex_max, gw_over, ex_over = gather(
            wait_t, work32, gw_b, gw_fin, ex_b, ex_fin)
        return dict(gw_wait=gw_wait, ex_max=ex_max, gw_over=gw_over,
                    ex_over=ex_over, work_sum=work_sum, wait=wait_t)

    start_pref = (q["arrival_s"][None, None, :]
                  + q["ingress_extra0"][None]).expand(F, P, R)
    c = finish_iter(work0, work0_sum, q["gw_b0"][None], q["gw_fin0"][None],
                    q["ex_b0"][None], q["ex_fin0"][None])
    for _ in range(n_iter - 1):
        layer_arr, exp_arr, _, _ = schedule(c["gw_wait"], c["ex_max"],
                                            start_pref)
        work = bin_work(layer_arr, exp_arr)                   # (F, SR, T)
        gw_b, gw_fin = to_bins(layer_arr)
        ex_b, ex_fin = to_bins(exp_arr)
        c = finish_iter(work.to(torch.float32), work.sum(dim=2),
                        gw_b, gw_fin, ex_b, ex_fin)
    # Fold the final gather into the schedule once more (see run_legacy).
    _, _, tok_total, seg_incl = schedule(c["gw_wait"], c["ex_max"],
                                         start_pref)
    ttft = q["ingress_extra0"][None] + tok_total[:, :, :R]
    out = dict(ttft=ttft, e2e=ttft + seg_incl[:, :, q["last_tok"]],
               tok_total=tok_total,
               tok_over=c["gw_over"].any(dim=3) | c["ex_over"].any(dim=3),
               work_sum=c["work_sum"])
    if want_wait:
        out["wait"] = c["wait"]
    return out


# --------------------------------------------------------------------- #
# The fleet simulator
# --------------------------------------------------------------------- #


class FleetSim:
    """Request-level serving simulator for a sweep of placement plans or
    time-indexed :class:`~repro_torch.core.schedule.PlanSchedule` rows.

    Counterpart of ``repro.traffic.queueing.FleetSim`` (same constructor
    and the same rate-independent precompute), plus ``device``: where the
    engine pass, the fused fixed point and the host path's scan run
    (CUDA unless the caller asks for the CPU).
    """

    def __init__(
        self,
        plans: list,
        topo: TopologySample,
        activation: ActivationModel,
        workload: MoEWorkload,
        compute: ComputeConfig,
        requests: RequestBatch,
        rng: np.random.Generator,
        qcfg: QueueConfig = QueueConfig(),
        ground=None,
        ctx_len: int = 1024,
        eta: float = 1.0,
        include_lm_head: bool = True,
        batch: ScheduleBatch | None = None,
        min_bins: int = 0,
        service_model=None,
        probes=None,
        batching=None,
        device="cuda",
    ):
        """Build the simulator and run every rate-independent precompute.

        Arguments as the reference's ``FleetSim``; ``ground``,
        ``probes``, ``batching`` and an AIMD/PID ``qcfg.admission`` are
        not ported yet and raise ``NotImplementedError``.
        """
        if ground is not None:
            raise _not_ported("FleetSim(ground=...)", "ground/admission")
        acfg = qcfg.admission
        if acfg is not None and getattr(acfg, "policy", None) in ("aimd",
                                                                   "pid"):
            raise _not_ported("QueueConfig.admission (AIMD/PID)",
                              "ground/admission")
        if batching is not None:
            raise _not_ported("FleetSim(batching=...)", "batching")
        if probes is not None:
            raise _not_ported("FleetSim(probes=...)", "obs probes")
        self.device = resolve_device(device)
        self.plans = list(plans)
        self.schedules = [as_schedule(p, topo.n_slots) for p in self.plans]
        self.requests = requests
        self.qcfg = qcfg
        self.activation = activation
        self.topo = topo
        self.workload = workload
        self.compute = compute

        P = len(self.schedules)
        R = requests.n_requests
        if R == 0:
            raise ValueError("empty request trace")
        L = activation.n_layers
        n_exp = activation.n_experts
        K = activation.top_k
        N = requests.total_decode_tokens
        M = R + N
        self.n_plans, self.n_requests = P, R
        self.n_decode_tokens, self.n_tokens = N, M
        self.n_layers, self.n_stations = L, topo.n_sats
        self.n_topo_slots = topo.n_slots

        tok_req = requests.request_of_token()                    # (N,)
        self.tok_req = tok_req

        # --- slots from wall-clock time (one slot per request) ------------
        slot_r = slot_of_time(requests.arrival_s, qcfg.slot_period_s,
                              topo.n_slots)
        self.slots = np.concatenate([slot_r, slot_r[tok_req]])   # (M,)

        # --- ingress (no ground segment: zero uplink, zero offset) ---------
        if batch is None:
            batch = ScheduleBatch.from_schedules(self.schedules, topo,
                                                 eta=eta)
        self.batch = batch
        self.fail_ingress = np.zeros((P, R), dtype=bool)
        self.ingress_extra = np.zeros((P, R))

        # --- engine pass: base (zero-load) per-token latencies -------------
        svc = resolve_service_model(service_model, workload, compute)
        self.service_model = svc
        draws = np.stack([activation.sample(layer, rng, M)
                          for layer in range(L)])                 # (L, M, K)
        self.draws = draws
        self.engine_results = evaluate_schedules(
            self.schedules, topo, activation, workload, compute, rng,
            n_tokens=M, ctx_len=ctx_len, include_lm_head=include_lm_head,
            eta=eta, batch=batch, slots=self.slots, draws=draws,
            service_model=svc, device=self.device)
        token_lat = np.stack(
            [r.token_latency_s for r in self.engine_results])     # (P, M)
        layer_lat = np.stack(
            [r.layer_latency_s for r in self.engine_results])     # (P, M, L)

        # Undeliverable tokens fail the whole request; zero them so the
        # segmented cumsums of the other requests stay finite.
        self.nan_tok = ~np.isfinite(token_lat)
        token_lat = np.where(self.nan_tok, 0.0, token_lat)
        layer_lat = np.where(np.isfinite(layer_lat), layer_lat, 0.0)

        t_gateway = svc.gateway_s(ctx_len)
        t_expert = svc.expert_scalar
        t_head = svc.head_s if include_lm_head else 0.0
        self.t_gateway, self.t_expert = t_gateway, t_expert

        # --- zero-load per-layer costs -------------------------------------
        incr_layer = t_gateway + t_expert * K / n_exp
        extra_layer = (requests.prompt_len - 1).astype(np.float64) \
            * incr_layer                                          # (R,)

        if svc.per_satellite:
            # Batch-amortized gateway service (calibrated mode).
            dec_lat = np.where(self.nan_tok[:, R:], np.nan, token_lat[:, R:])
            with np.errstate(invalid="ignore"):
                mean_tok = float(np.nanmean(dec_lat)) if N else 0.0
            if not np.isfinite(mean_tok) or mean_tok <= 0.0:
                mean_tok = L * t_gateway
            dur = requests.decode_len.astype(np.float64) * mean_tok
            arr = requests.arrival_s.astype(np.float64)
            started = np.searchsorted(arr, arr, side="right")
            ended = np.searchsorted(np.sort(arr + dur), arr, side="right")
            conc = np.maximum(started - ended, 1)                 # (R,)
            self.decode_batch_est = conc
            pre_gw = requests.prompt_len.astype(np.float64) \
                * svc.gateway_s(ctx_len, batch=requests.prompt_len)
            dec_gw = svc.gateway_s(ctx_len, batch=conc)[tok_req]
            self.gw_service = np.concatenate([pre_gw, dec_gw])    # (M,)
        else:
            self.decode_batch_est = None
            self.gw_service = np.concatenate([
                requests.prompt_len.astype(np.float64) * t_gateway,
                np.full(N, t_gateway),
            ])                                                    # (M,)
        self.eff_layer = layer_lat.copy()                         # (P, M, L)
        self.eff_layer[:, :R, :] += extra_layer[None, :, None]
        self.tok_base = token_lat.copy()                          # (P, M)
        self.tok_base[:, :R] += L * extra_layer[None, :]
        self.start_pref = requests.arrival_s[None, :] \
            + self.ingress_extra                                  # (P, R)
        self.first_tok = np.cumsum(requests.decode_len) \
            - requests.decode_len                                 # (R,)

        # --- queue events: (plan, station, request, work) ------------------
        self.gateways_slot = batch.gateways_by_slot()         # (P, N_T, L)
        self.expert_sats_slot = batch.expert_sats_by_slot()   # (P,N_T,L,I)
        eta_slot = batch.eta_by_slot()                        # (P, N_T)
        gw_tok = self.gateways_slot[:, self.slots]            # (P, M, L)
        sats_tok = self.expert_sats_slot[:, self.slots]       # (P, M, L, I)
        eta_tok = eta_slot[:, self.slots]                     # (P, M)

        gw_station = gw_tok
        gw_work = np.broadcast_to(self.gw_service[None, :, None],
                                  (P, M, L)).copy()
        gw_work[:, :, L - 1] += t_head
        gw_req = np.concatenate([np.arange(R), tok_req])          # (M,)

        draws_mlk = np.moveaxis(draws, 0, 1)                      # (M, L, K)
        exp_sat_tok = np.take_along_axis(
            sats_tok, draws_mlk[None], axis=3)                    # (P,M,L,K)
        dec_exp_station = exp_sat_tok[:, R:]                      # (P,N,L,K)
        probs = activation.all_probs()                            # (L, I)
        pre_exp_station = sats_tok[:, :R]                         # (P,R,L,I)
        if svc.per_satellite:
            exp_sec = np.asarray(svc.expert_s(), dtype=np.float64)  # (I,)
            inv_sp = np.asarray(svc.inv_speed(topo.n_sats),
                                dtype=np.float64)                 # (V,)
            dec_exp_work = (exp_sec[draws_mlk[R:]][None]
                            * inv_sp[dec_exp_station]
                            / eta_tok[:, R:, None, None])
            pre_exp_work = (requests.prompt_len[None, :, None, None]
                            * probs[None, None, :, :]
                            * exp_sec[None, None, None, :]
                            * inv_sp[pre_exp_station]
                            / eta_tok[:, :R, None, None])
        else:
            dec_exp_work = np.broadcast_to(
                (t_expert / eta_tok[:, R:])[..., None, None],
                dec_exp_station.shape)
            pre_exp_work = np.broadcast_to(
                requests.prompt_len[None, :, None, None]
                * probs[None, None, :, :] * t_expert
                / eta_tok[:, :R, None, None], (P, R, L, n_exp))

        ev_station = np.concatenate([
            gw_station.reshape(P, -1),
            dec_exp_station.reshape(P, -1),
            pre_exp_station.reshape(P, -1),
        ], axis=1)                                                # (P, E)
        ev_work = np.concatenate([
            gw_work.reshape(P, -1),
            dec_exp_work.reshape(P, -1),
            pre_exp_work.reshape(P, -1),
        ], axis=1)                                                # (P, E)
        ev_req = np.concatenate([
            np.broadcast_to(gw_req[:, None], (M, L)).ravel(),
            np.broadcast_to(tok_req[:, None, None], (N, L, K)).ravel(),
            np.broadcast_to(np.arange(R)[:, None, None],
                            (R, L, n_exp)).ravel(),
        ])                                                        # (E,)

        self.gather_gw_station = gw_station                       # (P, M, L)
        self.gather_exp_station = exp_sat_tok                     # (P,M,L,K)

        # Chunked service: a deposit larger than one bin of capacity is
        # spread over consecutive bins at the service rate.
        dt = qcfg.dt_s
        w_flat = ev_work.ravel()
        n_ch = np.maximum(np.ceil(w_flat / dt).astype(np.int64), 1)
        self._rep = np.repeat(np.arange(w_flat.size), n_ch)
        self._offs = np.arange(self._rep.size) \
            - np.repeat(np.cumsum(n_ch) - n_ch, n_ch)
        self.ev_chunk_work = np.minimum(w_flat[self._rep]
                                        - self._offs * dt, dt)
        self.ev_chunk_station = ev_station.ravel()[self._rep]
        self.ev_chunk_plan = np.broadcast_to(
            np.arange(P)[:, None], ev_work.shape).ravel()[self._rep]
        self.ev_chunk_req = np.broadcast_to(
            ev_req[None, :], ev_work.shape).ravel()[self._rep]
        self._n_events = ev_work.size

        # Fused-path gather indices into the flattened [layer_arr |
        # exp_arr] pair, in the ev_* block order.
        p_i = np.arange(P)[:, None, None]
        m_i = np.arange(M)[None, :, None]
        l_i = np.arange(L)[None, None, :]
        gw_src = (p_i * M + m_i) * L + l_i                        # (P, M, L)
        exp_src = P * M * L + gw_src                              # exp_arr
        ev_src = np.concatenate([
            gw_src.reshape(P, -1),
            np.broadcast_to(exp_src[:, R:, :, None],
                            (P, N, L, K)).reshape(P, -1),
            np.broadcast_to(exp_src[:, :R, :, None],
                            (P, R, L, n_exp)).reshape(P, -1),
        ], axis=1).ravel()
        self._chunk_src = ev_src[self._rep]
        self._chunk_row = self.ev_chunk_plan * self.n_stations \
            + self.ev_chunk_station
        self._dev: dict | None = None

        # --- time bins ----------------------------------------------------
        start_dec0, _, c00 = self._chain(self.tok_base, self.start_pref)
        end0 = start_dec0 + self.tok_base[:, R:]
        horizon = max(float(requests.arrival_s.max()),
                      float(np.where(np.isfinite(end0), end0, 0.0).max()),
                      float(np.where(np.isfinite(c00), c00, 0.0).max()))
        self.n_bins = max(
            int(np.ceil((horizon + qcfg.tail_s) / qcfg.dt_s)) + 1,
            int(min_bins))
        if self.n_bins > 2_000_000:
            raise ValueError(
                f"{self.n_bins} time bins — raise dt_s or shrink the horizon")

        self._build_migration_load()
        self.admission_on = False
        self._build_row_map()
        self._build_fused_tables()

        # Filled by ``run``: the last fleet scan's backlog (see last_wait).
        self._last_wait: np.ndarray | None = None
        self._last_wait_rows: torch.Tensor | None = None

    # ----------------------------------------------------------------- #

    def _build_migration_load(self) -> None:
        """Background work of each schedule's plan switches: per moved
        expert, ``bytes * 8 / migration_rate_gbps`` seconds on the
        destination satellite's queue, chunked into dt bins from the
        slot boundary (the reference's law)."""
        qcfg = self.qcfg
        dt, T, S = qcfg.dt_s, self.n_bins, self.n_stations
        sec_per_expert = (qcfg.migration_bytes_per_expert * 8.0
                          / (qcfg.migration_rate_gbps * 1e9))
        flat_parts: list[np.ndarray] = []
        work_parts: list[np.ndarray] = []
        self.migration_bytes = np.zeros(self.n_plans)
        for p, sched in enumerate(self.schedules):
            for t_b, mig in sched.migrations_over(
                    T * dt, qcfg.slot_period_s,
                    qcfg.migration_bytes_per_expert):
                self.migration_bytes[p] += mig.bytes_moved
                if mig.n_moved == 0 or sec_per_expert <= 0.0:
                    continue
                n_ch = max(int(np.ceil(sec_per_expert / dt)), 1)
                bins = np.minimum(int(t_b / dt) + np.arange(n_ch), T - 1)
                w = np.minimum(sec_per_expert - np.arange(n_ch) * dt, dt)
                fl = ((p * S + mig.new_sats[:, None]) * T
                      + bins[None, :]).ravel()
                flat_parts.append(fl)
                work_parts.append(np.broadcast_to(
                    w[None, :], (mig.n_moved, n_ch)).ravel())
        self._mig_flat = (np.concatenate(flat_parts) if flat_parts
                          else np.empty(0, dtype=np.int64))
        self._mig_work = (np.concatenate(work_parts) if work_parts
                          else np.empty(0, dtype=np.float64))

    def _build_row_map(self) -> None:
        """Compact the (plan, satellite) rows the fused path keeps dense:
        only rows that can receive a deposit or be read; every other
        station carries exactly zero backlog, so dropping it is exact."""
        P, S, T = self.n_plans, self.n_stations, self.n_bins
        p_idx = np.arange(P)[:, None, None]
        gw_rows = p_idx * S + self.gather_gw_station              # (P,M,L)
        ex_rows = p_idx[..., None] * S + self.gather_exp_station
        used = [self._chunk_row, gw_rows.ravel(), ex_rows.ravel()]
        if self._mig_flat.size:
            used.append(self._mig_flat // T)
        rows = np.unique(np.concatenate(used))
        inv = np.full(P * S, -1, dtype=np.int64)
        inv[rows] = np.arange(rows.size)
        self._active_rows = rows
        self._row_inv = inv
        self.n_rows = int(rows.size)
        self._chunk_rowc = inv[self._chunk_row].astype(np.int32)
        self._gw_rowc = inv[gw_rows]                              # (P,M,L)
        self._ex_rowc = inv[ex_rows]                              # (P,M,L,K)

    def _expand_rows(self, arr: np.ndarray) -> np.ndarray:
        """Scatter a compact-row array (..., n_rows) back to (..., P, S)."""
        full = np.zeros(arr.shape[:-1] + (self.n_plans * self.n_stations,),
                        dtype=arr.dtype)
        full[..., self._active_rows] = arr
        return full.reshape(arr.shape[:-1]
                            + (self.n_plans, self.n_stations))

    def _build_fused_tables(self) -> None:
        """The peeled first iteration's static bins, and the chunk tables
        stably re-ordered by compact row (so each row's deposits are one
        contiguous run of the table, in event order)."""
        P, M, L = self.n_plans, self.n_tokens, self.n_layers
        z = np.zeros((P, M, L))
        layer0, exp0, *_ = self._schedule(z, z, self.start_pref)
        self._gw_b0, self._gw_fin0 = self._to_bins(layer0)
        self._ex_b0, self._ex_fin0 = self._to_bins(exp0)
        base0, fin0 = self._to_bins(self._event_times(layer0, exp0))
        bins0 = np.minimum(base0[self._rep] + self._offs, self.n_bins - 1)
        perm = np.argsort(self._chunk_rowc, kind="stable")
        self._f_src = self._chunk_src[perm]
        self._f_offs = self._offs[perm]
        self._f_work = self.ev_chunk_work[perm]
        self._f_rowc = self._chunk_rowc[perm]
        self._f_req = self.ev_chunk_req[perm]
        self._f_bins0 = bins0[perm]
        self._f_fin0 = fin0[self._rep][perm]
        if self._mig_flat.size:
            flat = self._row_inv[self._mig_flat // self.n_bins] \
                * self.n_bins + self._mig_flat % self.n_bins
            self._mig_rm = np.bincount(
                flat, weights=self._mig_work,
                minlength=self.n_rows * self.n_bins
            ).reshape(self.n_rows, self.n_bins)
        else:
            self._mig_rm = None

    # ----------------------------------------------------------------- #

    def _chain(self, tok_total: np.ndarray, start_pref: np.ndarray):
        """Autoregressive chaining: (decode token starts (P, N), their
        per-request inclusive cumsums (P, N), prefill completion (P, R))."""
        R = self.n_requests
        dec = tok_total[:, R:]
        cs = np.cumsum(dec, axis=1)
        base = (cs - dec)[:, self.first_tok][:, self.tok_req]
        seg_excl = (cs - dec) - base
        c0 = start_pref + tok_total[:, :R]
        start_dec = c0[:, self.tok_req] + seg_excl
        return start_dec, cs - base, c0

    def _schedule(self, gw_wait: np.ndarray, ex_max: np.ndarray,
                  start_pref: np.ndarray):
        """Wait-augmented schedule: per-(plan, token, layer) gateway and
        expert arrival times, plus per-token total latencies."""
        lay_cost = self.eff_layer + gw_wait + ex_max              # (P, M, L)
        tok_total = self.tok_base + gw_wait.sum(2) + ex_max.sum(2)
        start_dec, seg_incl, c0 = self._chain(tok_total, start_pref)
        start_all = np.concatenate([start_pref, start_dec], axis=1)
        layer_arr = start_all[:, :, None] + _exclusive_cumsum(lay_cost, 2)
        exp_arr = layer_arr + gw_wait + self.gw_service[None, :, None]
        return layer_arr, exp_arr, tok_total, seg_incl, c0

    def _to_bins(self, times: np.ndarray):
        """Clip finite ``times`` to bin indices; returns (bins, finite)."""
        finite = np.isfinite(times)
        b = np.where(
            finite,
            np.clip((np.where(finite, times, 0.0) / self.qcfg.dt_s)
                    .astype(np.int64), 0, self.n_bins - 1), 0)
        return b, finite

    def _event_times(self, layer_arr: np.ndarray,
                     exp_arr: np.ndarray) -> np.ndarray:
        """(P*E,) arrival time of every queue event under a schedule."""
        P, R = self.n_plans, self.n_requests
        return np.concatenate([
            layer_arr.reshape(P, -1),
            np.broadcast_to(
                exp_arr[:, R:, :, None],
                (P, self.n_decode_tokens, self.n_layers,
                 self.activation.top_k)).reshape(P, -1),
            np.broadcast_to(
                exp_arr[:, :R, :, None],
                (P, R, self.n_layers, self.activation.n_experts))
            .reshape(P, -1),
        ], axis=1).ravel()

    def _bin_work(self, layer_arr, exp_arr, active2d):
        """Offered work (P, S, T) for the current schedule + per-plan
        request-activity mask ``active2d`` (P, R)."""
        P = self.n_plans
        S, T = self.n_stations, self.n_bins
        ev_time = self._event_times(layer_arr, exp_arr)           # (P*E,)
        base_bin, finite = self._to_bins(ev_time)
        bins = np.minimum(base_bin[self._rep] + self._offs, T - 1)
        w = self.ev_chunk_work * finite[self._rep] \
            * active2d[self.ev_chunk_plan, self.ev_chunk_req]
        flat = (self.ev_chunk_plan * S + self.ev_chunk_station) * T + bins
        if self._mig_flat.size:
            flat = np.concatenate([flat, self._mig_flat])
            w = np.concatenate([w, self._mig_work])
        return np.bincount(flat, weights=w,
                           minlength=P * S * T).reshape(P, S, T)

    def _gather(self, wait, overload, layer_arr, exp_arr):
        """Per-(plan, token, layer) gateway wait, expert branch-max wait,
        and overload flags, read at the schedule's arrival bins."""
        p_idx = np.arange(self.n_plans)[:, None, None]
        gw_b, gw_fin = self._to_bins(layer_arr)
        gw_wait = np.where(gw_fin,
                           wait[p_idx, self.gather_gw_station, gw_b], 0.0)
        gw_over = gw_fin & overload[p_idx, self.gather_gw_station, gw_b]
        ex_b, ex_fin = self._to_bins(exp_arr)
        ex_b4, ex_f4 = ex_b[..., None], ex_fin[..., None]
        ex_wait = np.where(
            ex_f4, wait[p_idx[..., None], self.gather_exp_station, ex_b4],
            0.0)
        ex_over = ex_f4 & \
            overload[p_idx[..., None], self.gather_exp_station, ex_b4]
        return gw_wait, ex_wait.max(axis=3), gw_over, ex_over.any(axis=3)

    @property
    def last_wait(self) -> np.ndarray | None:
        """(P, S, T) float32 backlog per (plan, satellite, bin) of the last
        fleet scan (the re-placement controller's observation).  ``run``
        keeps it on the device in compact rows; it is copied to the host
        and expanded here, on first read."""
        if self._last_wait is None and self._last_wait_rows is not None:
            rows = self._last_wait_rows.cpu().numpy()
            self._last_wait = np.moveaxis(self._expand_rows(rows), 0, 2)
            self._last_wait_rows = None
        return self._last_wait

    @last_wait.setter
    def last_wait(self, wait: np.ndarray | None) -> None:
        self._last_wait, self._last_wait_rows = wait, None

    def satellite_backlog(self, plan: int, t_s: float) -> np.ndarray:
        """(V,) seconds of backlog per satellite that plan row ``plan``
        observed at wall-clock ``t_s`` in the last ``run``."""
        if self.last_wait is None:
            return np.zeros(self.n_stations)
        b = min(int(t_s / self.qcfg.dt_s), self.n_bins - 1)
        return self.last_wait[plan, :, b]

    # ----------------------------------------------------------------- #

    def _device_tables(self) -> dict:
        """The fused fixed point's rate-independent tables on the
        simulator's device (built once): the zero-load schedule tensors
        in float64, the row and bin indices, the densified migration
        background load."""
        if self._dev is not None:
            return self._dev
        dev, qcfg = self.device, self.qcfg

        def put(a, dtype=None):
            t = torch.from_numpy(np.array(a))     # a writable copy
            return t.to(device=dev, dtype=dtype)

        d = dict(
            dt=torch.tensor(float(qcfg.dt_s), dtype=torch.float64,
                            device=dev),
            cap=torch.tensor(float(qcfg.buffer_s), dtype=torch.float32,
                             device=dev),
            cap32=float(np.float32(qcfg.buffer_s)),
            dt32=float(np.float32(qcfg.dt_s)),
            eff_layer=put(self.eff_layer, torch.float64),
            tok_base=put(self.tok_base, torch.float64),
            gw_service=put(self.gw_service, torch.float64),
            arrival_s=put(self.requests.arrival_s, torch.float64),
            ingress_extra0=put(self.ingress_extra, torch.float64),
            first_tok=put(self.first_tok, torch.int64),
            tok_req=put(self.tok_req, torch.int64),
            last_tok=put(self.first_tok + self.requests.decode_len - 1,
                         torch.int64),
            gw_rows=put(self._gw_rowc, torch.int64),
            ex_rows=put(self._ex_rowc, torch.int64),
            gw_b0=put(self._gw_b0, torch.int64),
            gw_fin0=put(self._gw_fin0),
            ex_b0=put(self._ex_b0, torch.int64),
            ex_fin0=put(self._ex_fin0),
        )
        if self._mig_rm is not None:
            d["mig_dense"] = put(self._mig_rm, torch.float64)
        self._dev = d
        return d

    def chunk_table(self, masks: np.ndarray) -> dict:
        """The compacted chunk table of one launch over (F, R) masks, as
        host arrays (the reference's ``_launch`` compaction, padding
        included), plus ``row_ptr``: the table is grouped by ``fprow``
        (F-major, then the static row order) up to the padding, and row
        r owns entries [row_ptr[r], row_ptr[r+1])."""
        F = masks.shape[0]
        T, SR = self.n_bins, self.n_rows
        cids = [np.flatnonzero(masks[f, self._f_req]) for f in range(F)]
        f_id = np.repeat(np.arange(F),
                         np.array([c.size for c in cids], dtype=np.int64))
        cid = (np.concatenate(cids) if cids
               else np.empty(0, dtype=np.int64))
        n = cid.size
        n_pad = max(-(-n // _CHUNK_BLOCK), 1) * _CHUNK_BLOCK
        pml2 = 2 * self.n_plans * self.n_tokens * self.n_layers
        src = np.zeros(n_pad, dtype=np.int64)
        src[:n] = f_id * pml2 + self._f_src[cid]
        offs = np.zeros(n_pad, dtype=np.int64)
        offs[:n] = self._f_offs[cid]
        work = np.zeros(n_pad)
        work[:n] = self._f_work[cid]
        fprow = np.zeros(n_pad, dtype=np.int64)
        fprow[:n] = f_id * SR + self._f_rowc[cid]
        row_ptr = np.searchsorted(fprow[:n], np.arange(F * SR + 1),
                                  side="left")
        flat0 = fprow[:n] * T + self._f_bins0[cid]
        return dict(src=src, offs=offs, work=work, fprow=fprow,
                    row_ptr=row_ptr, n=n, flat0=flat0,
                    work0=self._f_work[cid] * self._f_fin0[cid])

    def _launch(self, masks: np.ndarray, want_wait: bool) -> dict:
        """One fused fixed point over the leading sweep axis F.

        The request-activity masks fold into the compacted chunk table
        (only active chunks are deposited); iteration 1's work plane is
        one host ``np.bincount`` over the static zero-wait bins, as in
        the reference.  Returns the :func:`_fleet_fixed_point` outputs as
        host arrays, each with a leading F axis; ``wait``, when asked
        for, stays a device tensor.
        """
        F = masks.shape[0]
        T, SR = self.n_bins, self.n_rows
        ct = self.chunk_table(masks)
        # astype: the bincount of an empty chunk set is int64.
        plane0 = np.bincount(ct["flat0"], weights=ct["work0"],
                             minlength=F * SR * T).reshape(F, SR, T) \
            .astype(np.float64, copy=False)
        if self._mig_rm is not None:
            plane0 += self._mig_rm[None]
        work0_sum = plane0.sum(axis=2)                            # (F, SR)
        dev = self.device
        chunks = {k: torch.from_numpy(ct[k]).to(dev)
                  for k in ("src", "offs", "work", "fprow", "row_ptr")}
        out = _fleet_fixed_point(
            self._device_tables(), chunks,
            torch.from_numpy(plane0.astype(np.float32)).to(dev),
            torch.from_numpy(work0_sum).to(dev),
            max(1, self.qcfg.iterations), T, SR, want_wait)
        # The (T, F, rows) wait trace stays on the device (see last_wait).
        return {k: v if k == "wait" else v.cpu().numpy()
                for k, v in out.items()}

    def run(self, active: np.ndarray | None = None,
            zero_load: bool = False,
            kv_slots: int | None = None, *,
            replan=None, replan_rng=None) -> TrafficResult:
        """Simulate with an optional per-request activity mask and return
        per-plan traffic metrics (one fused fixed point on the device).

        ``zero_load`` delegates to the host path; ``replan`` (the joint
        control plane) is not ported yet.
        """
        if replan is not None or replan_rng is not None:
            raise _not_ported("run(replan=...)", "replan")
        if zero_load:
            return self.run_legacy(active, zero_load=True,
                                   kv_slots=kv_slots)
        if active is None:
            active = np.ones(self.n_requests, dtype=bool)
        active = np.asarray(active, dtype=bool)
        out = self._launch(active[None, :], want_wait=True)
        self.last_wait = None
        self._last_wait_rows = out.pop("wait")[:, 0, :]  # (T, rows), device
        out = {k: v[0] for k, v in out.items()}
        out["work_sum"] = self._expand_rows(out["work_sum"])
        return self._finalize(active, out, kv_slots)

    def run_many(self, active: np.ndarray | None = None, *,
                 ttft_targets: np.ndarray | None = None,
                 tpot_targets: np.ndarray | None = None,
                 kv_slots: int | None = None,
                 replan=None, replan_rng=None, base_scores=None,
                 cadences=None, mig_weights=None) -> list:
        """Run a whole sweep of (F, R) activity masks as one fused fixed
        point and return one :class:`TrafficResult` per entry, in order.

        Latency-target sweeps need the admission controller and the
        controller grid needs ``replan``; neither is ported yet.
        """
        if replan is not None or replan_rng is not None \
                or base_scores is not None or cadences is not None \
                or mig_weights is not None:
            raise _not_ported("run_many(replan=...) and its grid axes",
                              "replan")
        if ttft_targets is not None or tpot_targets is not None:
            raise _not_ported("run_many latency-target sweeps",
                              "ground/admission")
        if active is None:
            raise ValueError("run_many needs (F, R) activity masks")
        masks = np.asarray(active, dtype=bool)
        if masks.ndim != 2 or masks.shape[1] != self.n_requests:
            raise ValueError(f"active must be (F, {self.n_requests})")
        out = self._launch(masks, want_wait=False)
        out["work_sum"] = self._expand_rows(out["work_sum"])
        return [self._finalize(masks[f], {k: v[f] for k, v in out.items()},
                               kv_slots)
                for f in range(masks.shape[0])]

    def run_legacy(self, active: np.ndarray | None = None,
                   zero_load: bool = False,
                   kv_slots: int | None = None) -> TrafficResult:
        """Host-path reference fixed point: schedule, binning and gather
        in NumPy, the backlog scan on the device in float32 (the
        reference's ``run_legacy``)."""
        qcfg = self.qcfg
        req = self.requests
        P, R = self.n_plans, self.n_requests
        M, L = self.n_tokens, self.n_layers
        if active is None:
            active = np.ones(R, dtype=bool)
        active = np.asarray(active, dtype=bool)

        gw_wait = np.zeros((P, M, L))
        ex_max = np.zeros((P, M, L))
        gw_over = np.zeros((P, M, L), dtype=bool)
        ex_over = np.zeros((P, M, L), dtype=bool)
        start_pref = self.start_pref
        n_iter = 1 if zero_load else max(1, qcfg.iterations)
        for _ in range(n_iter):
            layer_arr, exp_arr, tok_total, seg_incl, c0 = \
                self._schedule(gw_wait, ex_max, start_pref)
            work = self._bin_work(layer_arr, exp_arr, active[None, :]
                                  & np.ones((P, 1), dtype=bool))
            if zero_load:
                break
            wait, dropped = _fleet_queue_scan(
                torch.from_numpy(work).to(self.device),
                float(qcfg.buffer_s), qcfg.dt_s)
            wait = wait.cpu().numpy()
            overload = dropped.cpu().numpy() > 0.0
            self.last_wait = wait
            gw_wait, ex_max, gw_over, ex_over = self._gather(
                wait, overload, layer_arr, exp_arr)
        layer_arr, exp_arr, tok_total, seg_incl, c0 = \
            self._schedule(gw_wait, ex_max, start_pref)

        last_tok = self.first_tok + req.decode_len - 1
        ttft = self.ingress_extra + tok_total[:, :R]              # (P, R)
        out = dict(
            ttft=ttft, e2e=ttft + seg_incl[:, last_tok],
            tok_total=tok_total,
            tok_over=gw_over.any(axis=2) | ex_over.any(axis=2),
            work_sum=work.sum(axis=2))
        return self._finalize(active, out, kv_slots)

    def _finalize(self, active: np.ndarray, out: dict,
                  kv_slots: int | None = None) -> TrafficResult:
        """Host post-processing shared by every execution path: delivery
        failure aggregation, the static KV admission cap, spans,
        utilization and the latency quantiles' NaN masking."""
        qcfg, req = self.qcfg, self.requests
        R = self.n_requests
        P = out["ttft"].shape[0]
        kv = qcfg.kv_slots if kv_slots is None else kv_slots
        ttft, e2e, tok_total = out["ttft"], out["e2e"], out["tok_total"]

        fail_tok = self.nan_tok | out["tok_over"]
        failed = fail_tok[:, :R] \
            | _segment_any(fail_tok[:, R:], self.tok_req, R)      # (P, R)
        failed = failed | self.fail_ingress

        # KV admission cap: reject arrivals that would exceed the
        # in-flight budget (in-flight counted over all offered requests).
        admitted = np.ones((P, R), dtype=bool)
        if kv > 0:
            comp = req.arrival_s[None, :] + np.nan_to_num(
                e2e, nan=np.inf, posinf=np.inf)
            comp = np.where(active[None, :], comp, -np.inf)
            n_inactive = int((~active).sum())
            arrived = np.cumsum(active)                           # (R,)
            # Batched searchsorted (side="right") by one stable argsort.
            keys = np.concatenate([
                np.sort(comp, axis=1),
                np.broadcast_to(req.arrival_s[None, :], (P, R))], axis=1)
            order = np.argsort(keys, axis=1, kind="stable")
            pos = np.empty_like(order)
            np.put_along_axis(pos, order, np.arange(2 * R)[None, :],
                              axis=1)
            done = pos[:, R:] - np.arange(R)[None, :] - n_inactive
            admitted = (arrived[None, :] - done) <= kv
        failed = failed | ~admitted

        served = active[None, :] & ~failed                        # (P, R)
        span = max(float(req.arrival_s[active].max()
                         - req.arrival_s[active].min()), qcfg.dt_s) \
            if active.any() else qcfg.dt_s
        util = out["work_sum"] / span                             # (P, S)

        plans_out = []
        for p in range(P):
            with np.errstate(invalid="ignore"):
                tpot = (e2e[p] - ttft[p]) / req.decode_len
            plans_out.append(PlanTraffic(
                plan_name=self.batch.names[p],
                active=active.copy(),
                served=served[p],
                ttft_s=np.where(served[p], ttft[p], np.nan),
                tpot_s=np.where(served[p], tpot, np.nan),
                e2e_s=np.where(served[p], e2e[p], np.nan),
                decode_len=req.decode_len,
                station_util=util[p],
                span_s=span,
                token_total_s=tok_total[p],
                shed=None,
                retries=None,
                migration_bytes=float(self.migration_bytes[p]),
            ))
        return TrafficResult(plans=plans_out, requests=req,
                             slots=self.slots, n_bins=self.n_bins,
                             dt_s=qcfg.dt_s)


def simulate_traffic(plans: list, topo: TopologySample,
                     activation: ActivationModel, workload: MoEWorkload,
                     compute: ComputeConfig, requests: RequestBatch,
                     rng: np.random.Generator,
                     qcfg: QueueConfig = QueueConfig(), **kwargs
                     ) -> TrafficResult:
    """Build a :class:`FleetSim` and run it with every request active."""
    sim = FleetSim(plans, topo, activation, workload, compute, requests,
                   rng, qcfg=qcfg, **kwargs)
    return sim.run()
