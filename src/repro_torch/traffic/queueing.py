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
  only the backlog scan (and the admission controller) on the device —
  the semantic anchor the fused path is held to.

With a ground segment (``ground=``) requests enter through their
gateway's best visible satellite, uplink and ingress hop billed.  Under
an AIMD or PID ``QueueConfig.admission`` the controller's admission
trace (:mod:`.admission`: ``backlog_scan``, the ``admission_window``
maxima of qhat and the ``admission_ctrl`` cell over control bins) is
resolved into shed
requests and gateway retries between fixed-point iterations.

Under continuous batching (``batching=``, :mod:`.batching`) every
deposit also lays down the decode work and the decode visits, and the
scan takes the effective work of the law.  With probes (``probes=``,
:mod:`repro_torch.obs.probes`) every launch leaves ``last_probes``: the
reference writes its probe ring from inside its scans, bin by bin; here
the final iteration's channels are gathered after its scan at the bins
the ring keeps.

A federation of constellations (:mod:`.federation`) runs its members as
the lanes of one F-leading fixed point.

The joint re-placement control plane (``run(replan=...)``,
``run_many(replan=...)``, :meth:`FleetSim.run_replan_grid`) runs probe ->
decide -> evaluate as one :func:`_ctrl_core` call on the simulator's
device: the probe and the decided schedule's evaluation are fixed points
(the latter over F-leading tables gathered by each cell's decided plan),
the decide walk is tensor code between them.  The reference's jit and
compile-cache machinery has no counterpart here: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.activation import ActivationModel
from ..core.calibration import resolve_service_model
from ..core.engine import (ScheduleBatch, evaluate_schedules,
                           schedule_ingress_offsets)
from ..core.latency import ComputeConfig, TopologySample
from ..core.schedule import (PlanSchedule, as_schedule, migration_matrix,
                             slot_of_time)
from ..core.workload import MoEWorkload
from ..kernels.admission_window import _seq_sum, qhat_of
from ..kernels.backlog_scan import backlog_scan
from ..kernels.deposit import deposit
from ..obs.probes import (DecisionTrace, ProbeConfig, ProbeRecord,
                          make_buffers, ring_bins)
from .admission import (admission_queue_scan, control_bin_flags,
                        control_segments, controller_states, resolve_admission)
from .batching import (BatchingConfig, batch_speedup_at,
                       batched_effective_work, effective_work_np,
                       windowed_counts, windowed_counts_torch)
from .ground import GroundSegment
from .metrics import PlanTraffic, TrafficResult
from .requests import RequestBatch


def _check_config(value, cls, name: str) -> None:
    """Refuse a ``name=`` option that is neither None nor a ``cls``."""
    if value is not None and not isinstance(value, cls):
        raise TypeError(f"{name}= takes a {cls.__name__} or None, not "
                        f"{type(value).__name__}")


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
        admission: Optional :class:`~.admission.AdmissionConfig`; a
            policy of ``"aimd"`` or ``"pid"`` runs the latency-target
            controller, ``"static"`` keeps the ``kv_slots`` cap.
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
    single-station M/D/1 check).  ``batching``: an optional
    :class:`~.batching.BatchingConfig`, whose law scales the station's
    work (each arrival one occupancy unit) and the within-bin prior work
    by the bin's speedup."""
    _check_config(batching, BatchingConfig, "batching")
    t = np.asarray(arrival_s, dtype=np.float64)
    if len(t) and not (np.diff(t) >= 0).all():
        raise ValueError("arrivals must be sorted")
    s = np.broadcast_to(np.asarray(service_s, dtype=np.float64), t.shape)
    horizon = (float(t[-1]) if len(t) else 0.0) \
        if horizon_s is None else horizon_s
    n_bins = int(np.floor(horizon / dt_s)) + 2
    bins = np.minimum((t / dt_s).astype(np.int64), n_bins - 1)
    work = np.bincount(bins, weights=s, minlength=n_bins)
    sp_bin = np.ones(n_bins)
    if batching is not None:
        cnt = np.bincount(bins, minlength=n_bins).astype(np.float64)
        table = batching.resolve_table()
        work, _ = effective_work_np(
            work, work, cnt, table, batching.b_cap,
            batching.window_bins(dt_s))
        sp_bin, _ = batch_speedup_at(
            windowed_counts(cnt, batching.window_bins(dt_s)),
            table, batching.b_cap)
    dev = resolve_device(device)
    wait_bins = _fleet_queue_scan(
        torch.from_numpy(work[None, None, :]).to(dev), float(buffer_s),
        dt_s)[0][0, 0].cpu().numpy()
    cs = np.cumsum(s)
    first = np.searchsorted(bins, bins, side="left")
    prior = ((cs - s) - (cs[first] - s[first])) / sp_bin[bins]
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


def _station_quantile(values: np.ndarray, ok: np.ndarray,
                      station: np.ndarray, n_stations: int,
                      q: float) -> np.ndarray:
    """(P, G) per-(plan, station) q-quantile of ``values`` (P, R) over
    the requests with ``ok`` set; stations with no valid request fall
    back to the plan-wide quantile (0 when nothing is valid at all)."""
    p = values.shape[0]
    out = np.zeros((p, n_stations))
    overall = np.array([
        np.quantile(values[i][ok[i]], q) if ok[i].any() else 0.0
        for i in range(p)])
    for g in range(n_stations):
        sel = ok & (station[None, :] == g)
        for i in range(p):
            out[i, g] = np.quantile(values[i][sel[i]], q) if sel[i].any() \
                else overall[i]
    return out


# --------------------------------------------------------------------- #
# The fused fixed point
# --------------------------------------------------------------------- #

#: The compacted chunk table is padded to a multiple of this (the
#: reference's compile-cache block; kept so the tables match it).
_CHUNK_BLOCK = 8192


def _resolve_attempts(q: dict, admit_floor: torch.Tensor,
                      per_entry: bool = False):
    """Per-request admission from the running-minimum admit trace
    ``admit_floor`` (T, F, P, G): each attempt's uniform draw against the
    probability in effect at its (bin, gateway), the first admitted
    feasible attempt winning (the reference's ``resolve_admission``,
    batched over F).  ``per_entry``: the attempt tables ``att_feasible``
    and ``att_extra`` are (F, P, A, R), else (P, A, R) shared.  The
    attempt bins, gateways and uniforms ``att_bin``, ``att_station`` and
    ``adm_u`` are (A, R), shared, or (F, A, R): a federation's lanes, each
    member's retries following its own ground visibility.  Returns
    (shed (F, P, R) bool, retries (F, P, R), ingress_extra (F, P, R)
    float64 of the attempt taken)."""
    F = admit_floor.shape[1]
    if q["att_bin"].dim() == 3:
        fi = torch.arange(F, device=admit_floor.device)[:, None, None]
        adm = admit_floor.permute(0, 1, 3, 2)[q["att_bin"], fi,
                                              q["att_station"]]
        adm = adm.permute(0, 3, 1, 2)                         # (F, P, A, R)
        u = q["adm_u"][:, None]
    else:
        adm = admit_floor.permute(0, 3, 1, 2)[q["att_bin"], q["att_station"]]
        adm = adm.permute(2, 3, 0, 1)                         # (F, P, A, R)
        u = q["adm_u"][None, None]
    feasible = q["att_feasible"] if per_entry else q["att_feasible"][None]
    ok = (u < adm) & feasible
    shed = ~ok.any(dim=2)
    retries = torch.where(shed, 0, ok.to(torch.uint8).argmax(dim=2))
    att_x = q["att_extra"] if per_entry else \
        q["att_extra"][None].expand((F,) + q["att_extra"].shape)
    ingress_extra = torch.gather(att_x, 2, retries[:, :, None, :])[:, :, 0]
    return shed, retries, ingress_extra


#: Cells of the (F * rows, T) plane the batching law takes at a time: its
#: float64 temporaries (about 16 of them) stay near 16 * 8 bytes a cell
#: of one block, not of the plane (9,504 x 40,966 cells, 3.1 GB a plane,
#: on the paper's world at F = 11).
LAW_BLOCK_CELLS = 1 << 24


def _effective_plane(work: torch.Tensor, work_dec: torch.Tensor,
                     cnt: torch.Tensor, batch: dict,
                     bins: torch.Tensor | None = None):
    """The batching law over (rows, T) float64 planes, a block of rows at a
    time: ``(work_eff, beff_at)`` with ``work_eff`` (rows, T) float32 (the
    law in float64, then the scan's downcast) and ``beff_at`` (rows, B)
    float32, B_eff at the bins ``bins`` (None without ``bins``)."""
    n_rows, n_bins = work.shape
    out = torch.empty((n_rows, n_bins), dtype=torch.float32,
                      device=work.device)
    beff_at = None if bins is None else torch.empty(
        (n_rows, bins.numel()), dtype=torch.float32, device=work.device)
    step = max(1, LAW_BLOCK_CELLS // max(1, n_bins))
    for r0 in range(0, n_rows, step):
        rs = slice(r0, r0 + step)
        eff, beff = batched_effective_work(
            work[rs], work_dec[rs],
            windowed_counts_torch(cnt[rs], batch["window"]), batch["table"],
            batch["bcap"])
        out[rs] = eff
        if bins is not None:
            beff_at[rs] = beff[:, bins]
    return out, beff_at


def _probe_channels(q: dict, probe: dict, wait_t: torch.Tensor,
                    work32: torch.Tensor, beff_at: torch.Tensor | None,
                    states: torch.Tensor | None) -> dict:
    """The probe ring's channels at the recorded bins ``probe["bins"]``
    (B,), taken from one iteration's scan: ``rows`` (B, C, F, SR) float32
    (the backlog before the bin, the work the scan took, the overflow
    ``max(wait + work - cap, 0)`` and under batching B_eff), and under
    admission ``aimd`` (B, 2, F, P) (qhat after the bin, the controller's
    window maximum after it, 0 at a control bin) and ``admit`` (B, F, P,
    G) (the controller's state after the bin): what the reference's
    scans write into the ring at those bins."""
    bins = probe["bins"]
    wait_b = wait_t[bins]                                     # (B, F, SR)
    work_b = work32[:, :, bins].permute(2, 0, 1)
    chans = [wait_b, work_b,
             torch.clamp_min((wait_b + work_b) - q["cap"], 0.0)]
    if beff_at is not None:
        chans.append(beff_at.permute(2, 0, 1))
    out = dict(rows=torch.stack(chans, dim=1))
    if states is None:
        return out
    # qhat after each bin of each recorded bin's control window (the
    # recorded bin last; shorter windows repeat it): its window maximum
    # is the controller's running window.
    idx = probe["win_idx"]                                    # (B, W)
    flat = idx.reshape(-1)
    n_bins = wait_t.shape[0]
    dt32 = torch.tensor(q["dt32"], dtype=torch.float32, device=wait_t.device)
    last = torch.clamp_min(torch.minimum(wait_t[-1] + work32[:, :, -1],
                                         q["cap"]) - dt32, 0.0)
    after = torch.where((flat == n_bins - 1)[:, None, None], last[None],
                        wait_t[torch.clamp_max(flat + 1, n_bins - 1)])
    slot = q["slot_of_bin"][flat].long()
    qhat = qhat_of(after, q["gw_rows_slot"][slot].long(),
                   q["exp_rows_slot"][slot].long()).reshape(
                       idx.shape + after.shape[1:2] + (-1,))  # (B, W, F, P)
    win = torch.where(probe["win_ctrl"][:, None, None], 0.0,
                      qhat.amax(dim=1))
    out["aimd"] = torch.stack([qhat[:, -1], win], dim=1)
    out["admit"] = states[probe["state_idx"]]
    return out


def _fleet_fixed_point(q: dict, chunks: dict, work0: torch.Tensor,
                       work0_sum: torch.Tensor, n_iter: int, n_bins: int,
                       n_rows: int, want_wait: bool,
                       ttft_target: torch.Tensor | None = None,
                       tpot_target: torch.Tensor | None = None, *,
                       batch: dict | None = None,
                       probe: dict | None = None) -> dict:
    """The fused fixed point of ``FleetSim.run``, over a sweep axis F.

    The reference's ``_fleet_fixed_point``: every tensor lives on one
    device; schedules, bins and deposits in float64,
    the backlog scan in float32 over the time-major view of the (F, rows,
    T) work plane.  The first iteration is peeled: its zero-wait schedule
    is static, so its work plane ``work0`` (F, rows, T) float32 and
    per-row sums ``work0_sum`` arrive precomputed, and the deposit runs
    for iterations 2..n only.

    Under admission (``q`` holds the controller's tables and the targets
    are given) each iteration also runs the controller over the new wait
    trace (:func:`.admission.controller_states`), keeps the admit trace
    as a running minimum (so the shed set only grows), resolves every
    request's attempts (:func:`_resolve_attempts`), and the next
    iteration's deposits skip shed requests and start each request after
    the ingress latency of the attempt it took.

    Under continuous batching (``batch``) each deposit is three: the
    work, the decode work (``chunks["wdec"]``) and the decode visits
    (``chunks["cntw"]``) over the same rows and bins; the scan and the
    gathers take the effective work (:func:`_effective_plane`),
    ``work_sum`` stays the raw offered sum.  ``work0`` is then the
    effective plane of iteration 1 (computed on the host).

    With ``probe`` the final iteration's channels are taken at the
    recorded bins (:func:`_probe_channels`) into ``out["probe"]``, with
    that iteration's gathered waits (``probe_gw_wait``/``probe_ex_wait``).

    The tables arrive plan-leading (``q["eff_layer"]`` (P, M, L), shared
    by the sweep) on every path but two, where they are F-leading
    (``eff_layer`` (F, P, M, L), and so ``tok_base``, ``ingress_extra0``,
    the gather rows and bins, the admission anchors ``ttft0`` (F, P, G)
    and ``tpot0`` (F, P), the station maps (NS, F, P, ...) and the
    attempt tables (F, P, A, R)), with the migration background load as
    ``mig_dense_f`` (F, rows, T): the joint control plane's schedule row
    (:func:`_ctrl_core`), whose tables are gathers by each entry's
    decided plan, and a federation's lanes (:mod:`.federation`), one
    member's padded tables a lane, which add per-lane attempt bins,
    gateways and uniforms (F, A, R).

    Args:
        q: Device tables (:meth:`FleetSim._device_tables`).
        chunks: Compacted deposit table: ``src`` (gather index into the
            F-flattened [layer_arr | exp_arr] pair), ``offs`` (chunk
            offset in bins), ``work`` (seconds), ``fprow`` (row of the
            (F * rows) plane), ``row_ptr`` (the table's row grouping,
            see ``kernels.deposit``), under admission ``fpr`` (index
            into the (F, P, R) shed mask) and under batching ``wdec`` and
            ``cntw``.
        work0: (F, rows, T) float32 iteration-1 work the scan takes.
        work0_sum: (F, rows) float64 per-row sum of iteration-1 offered
            work.
        n_iter: Fixed-point iterations.
        n_bins: T, the time-bin count.
        n_rows: Compacted queue-row count.
        want_wait: Also return the final (T, F, rows) backlog trace.
        ttft_target, tpot_target: (F,) float32 margin-scaled targets
            (admission only).
        batch: None, or ``table`` (the padded speedup table, float64 on
            the device), ``bcap`` (the batch cap), ``window`` (the
            occupancy window in bins) and, for a probed single
            iteration, ``beff0_at`` (F, rows, B) float32, iteration 1's
            B_eff at the recorded bins.
        probe: None, or ``bins`` (B,) recorded bins and under admission
            ``win_idx`` (B, W) the bins of each one's control window up
            to it (it last), ``win_ctrl`` (B,) its control flag and
            ``state_idx`` (B,) the controller state after it.

    Returns:
        Dict with a leading F axis: ``ttft``/``e2e`` (F, P, R),
        ``tok_total`` (F, P, M), ``tok_over`` (F, P, M) bool,
        ``shed``/``retries`` (F, P, R), ``work_sum`` (F, rows), iff
        ``want_wait`` ``wait``, and iff ``probe`` ``probe`` (the
        channels) with ``probe_gw_wait``/``probe_ex_wait`` (F, P, M, L).
    """
    first_tok, tok_req = q["first_tok"], q["tok_req"]
    F = work0.shape[0]
    R = first_tok.shape[0]
    fb = q["eff_layer"].dim() == 4            # F-leading tables
    P, M, L = q["eff_layer"].shape[-3:]

    def lead(x):
        return x if fb else x[None]
    T, SR = n_bins, n_rows
    dt, cap = q["dt"], q["cap"]
    f64 = torch.float64
    dev = work0.device
    adm_on = "ctrl" in q

    def to_bins(times):
        finite = torch.isfinite(times)
        b = (torch.where(finite, times, 0.0) / dt).to(torch.int64) \
            .clamp(0, T - 1)
        return torch.where(finite, b, 0), finite

    def schedule(gw_wait, ex_max, start_pref):
        lay_cost = lead(q["eff_layer"]) + gw_wait + ex_max
        tok_total = lead(q["tok_base"]) + _seq_sum(gw_wait) \
            + _seq_sum(ex_max)
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

    def bin_work(layer_arr, exp_arr, shed, record):
        """(work the scan takes (F, SR, T) float32, raw per-row sums
        (F, SR), B_eff at the recorded bins (F, SR, B) or None)."""
        flat_t = torch.cat([layer_arr.reshape(F, -1),
                            exp_arr.reshape(F, -1)], dim=1).reshape(-1)
        b_ch, fin = to_bins(flat_t[chunks["src"]])
        bins = torch.clamp_max(b_ch + chunks["offs"], T - 1)
        # Shed requests stop depositing: their values become zeros in
        # place, so the table keeps its row grouping (row_ptr).
        keep = ~shed.reshape(-1)[chunks["fpr"]] if adm_on else None

        def scat(name):
            vals = chunks[name] * fin
            if keep is not None:
                vals = vals * keep
            return deposit(chunks["fprow"], bins, vals, F * SR, T,
                           row_ptr=chunks["row_ptr"])       # (F * SR, T)
        work = scat("work").reshape(F, SR, T)
        if "mig_dense" in q:
            work = work + q["mig_dense"][None]
        elif "mig_dense_f" in q:
            work = work + q["mig_dense_f"]
        work_sum = work.sum(dim=2)
        if batch is None:
            return work.to(torch.float32), work_sum, None
        # The migration background load stays out of the decode planes:
        # it is not batchable decode work.
        work32, beff_at = _effective_plane(
            work.reshape(F * SR, T), scat("wdec"), scat("cntw"), batch,
            probe["bins"] if record else None)
        if beff_at is not None:
            beff_at = beff_at.reshape(F, SR, -1)
        return work32.reshape(F, SR, T), work_sum, beff_at

    def gather(wait_t, work32, gw_b, gw_fin, ex_b, ex_fin):
        f_idx = torch.arange(F, device=dev)[:, None, None, None]
        gw_rows, ex_rows = lead(q["gw_rows"]), lead(q["ex_rows"])
        w_g = wait_t[gw_b, f_idx, gw_rows]
        gw_wait = torch.where(gw_fin, w_g, 0.0).to(f64)
        gw_over = gw_fin & ((w_g + work32[f_idx, gw_rows, gw_b]) > cap)
        ex_b5, ex_f5 = ex_b[..., None], ex_fin[..., None]
        f_idx5 = f_idx[..., None]
        w_e = wait_t[ex_b5, f_idx5, ex_rows]
        ex_wait = torch.where(ex_f5, w_e, 0.0).to(f64)
        ex_over = ex_f5 & ((w_e + work32[f_idx5, ex_rows, ex_b5]) > cap)
        return gw_wait, ex_wait.amax(dim=4), gw_over, ex_over.any(dim=4)

    def finish_iter(work32, work_sum, gw_b, gw_fin, ex_b, ex_fin, c,
                    record=False, beff_at=None):
        work32_t = work32.permute(2, 0, 1).reshape(T, F * SR)
        wait_t = backlog_scan(work32_t, q["cap32"], q["dt32"]) \
            .reshape(T, F, SR)
        nxt = dict(c, work_sum=work_sum, wait=wait_t)
        states = None
        if adm_on:
            states = controller_states(
                wait_t, work32[:, :, -1], q["cap32"], q["dt32"],
                q["gw_rows_slot"], q["exp_rows_slot"], q["slot_of_bin"],
                q["seg"], q["n_ctrl"], q["ttft0"], q["tpot0"],
                torch.ones(adm_shape, dtype=torch.float32, device=dev),
                ttft_target, tpot_target, **q["adm_kw"])
            nxt["admit_floor"] = torch.minimum(c["admit_floor"],
                                               states[q["seg"]])
            nxt["shed"], nxt["retries"], nxt["ingress_extra"] = \
                _resolve_attempts(q, nxt["admit_floor"], fb)
        nxt.update(zip(("gw_wait", "ex_max", "gw_over", "ex_over"), gather(
            wait_t, work32, gw_b, gw_fin, ex_b, ex_fin)))
        if record:
            nxt["probe"] = _probe_channels(q, probe, wait_t, work32,
                                           beff_at, states)
        return nxt

    c = dict(shed=torch.zeros((F, P, R), dtype=torch.bool, device=dev),
             retries=torch.zeros((F, P, R), dtype=torch.int64, device=dev),
             ingress_extra=q["ingress_extra0"] if fb
             else q["ingress_extra0"][None].expand(F, P, R))
    if adm_on:
        # The controller's state per (entry, plan, gateway).
        adm_shape = q["ttft0"].shape if fb else (F,) + q["ttft0"].shape
        c["admit_floor"] = torch.ones((T,) + adm_shape, dtype=torch.float32,
                                      device=dev)
    c = finish_iter(work0, work0_sum, lead(q["gw_b0"]), lead(q["gw_fin0"]),
                    lead(q["ex_b0"]), lead(q["ex_fin0"]), c,
                    record=probe is not None and n_iter == 1,
                    beff_at=None if batch is None else batch.get("beff0_at"))
    for i in range(n_iter - 1):
        record = probe is not None and i == n_iter - 2
        start_pref = q["arrival_s"][None, None, :] + c["ingress_extra"]
        layer_arr, exp_arr, _, _ = schedule(c["gw_wait"], c["ex_max"],
                                            start_pref)
        work32, work_sum, beff_at = bin_work(layer_arr, exp_arr, c["shed"],
                                             record)
        gw_b, gw_fin = to_bins(layer_arr)
        ex_b, ex_fin = to_bins(exp_arr)
        c = finish_iter(work32, work_sum, gw_b, gw_fin, ex_b, ex_fin, c,
                        record=record, beff_at=beff_at)
    # Fold the final gather into the schedule once more (see run_legacy).
    start_pref = q["arrival_s"][None, None, :] + c["ingress_extra"]
    _, _, tok_total, seg_incl = schedule(c["gw_wait"], c["ex_max"],
                                         start_pref)
    ttft = c["ingress_extra"] + tok_total[:, :, :R]
    out = dict(ttft=ttft, e2e=ttft + seg_incl[:, :, q["last_tok"]],
               tok_total=tok_total,
               tok_over=c["gw_over"].any(dim=3) | c["ex_over"].any(dim=3),
               shed=c["shed"], retries=c["retries"],
               work_sum=c["work_sum"])
    if want_wait:
        out["wait"] = c["wait"]
    if probe is not None:
        out.update(probe=c["probe"], probe_gw_wait=c["gw_wait"],
                   probe_ex_wait=c["ex_max"])
    return out


# --------------------------------------------------------------------- #
# The joint control plane
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class _CtrlMeta:
    """Scalars of one joint-control-plane call (:func:`_ctrl_core`)."""

    n_iter: int          #: schedule<->queue fixed-point iterations
    n_bins: int          #: T, time bins
    n_rows: int          #: compact (plan, satellite) rows of the probe
    n_rows_sched: int    #: compact satellite rows of the schedule row
    n_cand: int          #: C, candidate-pool size
    n_slots: int         #: N_T, topology slots
    n_bounds: int        #: last decision boundary index (see replan.py)
    n_rounds: int        #: controller decide + evaluate rounds
    adm_on: bool         #: admission regime active
    mode_backlog: bool   #: backlog-inflated scoring (vs base scores only)
    hysteresis: float    #: relative switching threshold
    ref_q: float         #: admission reference quantile (0 if off)
    decide_bins: tuple   #: per-boundary backlog observation bin
    n_mig_chunks: int    #: dt-chunks one migration transfer spans
    mig_bounds: tuple    #: (prev_slot, cur_slot, first_bin) per boundary


def np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's pairwise order, as ``np.sum``
    adds a contiguous 1-d array: below 8 elements in index order from 0;
    up to 128 eight running sums (element j, j + 8, ...) combined as
    ``((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))``, then the
    remainder in order; above 128 the two halves (the first a multiple of
    8 long) each summed so, then added.  The re-placement score adds
    float32 backlogs with ``np.sum`` on the host
    (``replan.backlog_penalty_s``), and a decision on a near tie turns on
    the last bit of it."""
    def pair(y, n):
        if n < 8:
            res = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
            for i in range(n):
                res = res + y[..., i]
            return res
        if n <= 128:
            r = [y[..., j] for j in range(8)]
            i = 8
            while i + 8 <= n:
                for j in range(8):
                    r[j] = r[j] + y[..., i + j]
                i += 8
            res = ((r[0] + r[1]) + (r[2] + r[3])) \
                + ((r[4] + r[5]) + (r[6] + r[7]))
            while i < n:
                res = res + y[..., i]
                i += 1
            return res
        n2 = (n // 2) - ((n // 2) % 8)
        return pair(y[..., :n2], n2) + pair(y[..., n2:], n - n2)
    return pair(x, x.shape[-1])


def masked_quantile(vals: torch.Tensor, mask: torch.Tensor,
                    q: float) -> torch.Tensor:
    """``np.quantile(vals[mask], q)`` (linear interpolation) over the last
    axis, batched over the others, in float64; 0 where the mask is empty.
    Numpy's interpolation is kept with its asymmetry about t = 0.5 (``b -
    d * (1 - t)`` from t = 0.5 on, ``a + d * t`` below, each product and
    sum its own operation): the admission anchors need it bit for bit."""
    n = vals.shape[-1]
    s = torch.sort(torch.where(mask, vals, torch.inf), dim=-1).values
    nv = mask.sum(dim=-1)
    vi = q * (nv - 1).to(torch.float64)
    lo = torch.clamp_min(torch.floor(vi), 0.0)
    t = vi - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, torch.clamp_min(nv - 1, 0))
    a = torch.gather(s, -1, lo_i.clamp(0, n - 1)[..., None])[..., 0]
    b = torch.gather(s, -1, hi_i.clamp(0, n - 1)[..., None])[..., 0]
    d = b - a
    out = torch.where(t >= 0.5, b - d * (1.0 - t), a + d * t)
    return torch.where(nv > 0, out, 0.0)


#: Outputs of a fixed point that the control plane hands back.
_CTRL_KEEP = ("ttft", "e2e", "tok_total", "tok_over", "shed", "retries",
              "work_sum")


def _ctrl_core(q: dict, chunks: dict, work0: torch.Tensor,
               work0_sum: torch.Tensor, ttft_target, tpot_target, cc: dict,
               meta: _CtrlMeta, stage=None) -> dict:
    """The joint control plane: probe -> decide -> evaluate, over a
    leading controller-grid axis F (cadence x migration price x admission
    target cells), on the simulator's device.

    1. **probe**: the candidate pool's fleet fixed point (what ``run``
       computes), at the deduplicated admission-target width F_u of
       ``work0`` and gathered back to F (``cc["probe_gather"]``): the
       controller's observation;
    2. **decide**: the re-placement law of ``replan.build_replan_schedule``
       (backlog-inflated scores, hysteresis and migration-cost gates) as
       tensor ops over that observation, a Python loop over at most
       ``n_bounds + 1`` boundaries with a per-cell cadence mask;
    3. **evaluate**: a second fixed point over the decided schedule row,
       whose tables are gathers of the candidates' by each entry's
       decided plan per slot (the F-leading branch of
       :func:`_fleet_fixed_point`), with the migration background load of
       the decided switches; iteration 1's plane is deposited on the
       device from the gated chunk table.

    In backlog mode rounds 2..``n_rounds`` re-decide against the
    evaluation's own backlog and re-evaluate.  Each step replicates the
    host controller's arithmetic: the penalty sums in numpy's pairwise
    order (:func:`np_sum`), the anchors interpolate as ``np.quantile``
    (:func:`masked_quantile`), and the gated table sums each (row, bin)
    cell in a host evaluation's order.

    Args:
        q: The simulator's device tables (plan-leading).
        chunks: The probe's all-active chunk table at width F_u
            (``FleetSim.chunk_table``).
        work0, work0_sum: The probe's iteration-1 plane and row sums.
        ttft_target, tpot_target: (F,) float32 margin-scaled admission
            targets of the cells (None without admission).
        cc: Controller tables on the device (``FleetSim._ctrl_device``
            plus the grid's base scores, decide mask, migration prices,
            byte matrix, probe targets and gather).
        meta: :class:`_CtrlMeta`.
        stage: Optional callable, called with a stage's name as each of
            ``probe``, ``decide``, ``eval_consts`` and ``eval`` ends (an
            instrumentation hook: a timer there synchronizes the device).

    Returns:
        ``slot_plan`` (F, N_T) int64, ``telem`` (``scores`` (F, K, C),
        ``chosen``, ``switched``, ``mig_bytes`` (F, K) over the
        boundaries k < K = n_bounds + 1), and ``probe`` and ``sched``,
        the kept outputs (``_CTRL_KEEP``) of the probe's and the last
        evaluation's fixed points, each with a leading F axis.
    """
    def mark(name):
        if stage is not None:
            stage(name)

    C, T, SRs = meta.n_cand, meta.n_bins, meta.n_rows_sched
    _, M, L = q["eff_layer"].shape
    R = q["first_tok"].shape[0]
    dev = work0.device
    f32, f64 = torch.float32, torch.float64
    F = cc["decide_mask"].shape[0]
    f_i = torch.arange(F, device=dev)
    dbins = torch.tensor(meta.decide_bins, dtype=torch.int64, device=dev)

    probe = _fleet_fixed_point(
        q, chunks, work0, work0_sum, meta.n_iter, T, meta.n_rows, True,
        cc.get("probe_ttft"), cc.get("probe_tpot"))
    pg = cc["probe_gather"]
    probe_wait = probe.pop("wait")[dbins][:, pg]              # (K, F, SR)
    probe = {k: probe[k][pg] for k in _CTRL_KEEP}
    mark("probe")

    zero_col = torch.zeros((F, 1), dtype=f32, device=dev)

    def penalty(wait_b, rows_gw, rows_ex):
        # replan.backlog_penalty_s off one backlog snapshot: the gateway
        # chain's sum plus each layer's worst expert, summed.  Row index
        # n_rows reads the appended zero column (a satellite the
        # compaction dropped carries no backlog).
        w = torch.cat([wait_b, zero_col], dim=1)
        g = w[f_i[:, None, None], rows_gw]                   # (F, C, L)
        e = w[f_i[:, None, None, None], rows_ex]             # (F, C, L, I)
        return (np_sum(g) + np_sum(e.amax(dim=3))).to(f64)

    def decide(wait_dec, rows_gw_of, rows_ex_of):
        cur = torch.zeros(F, dtype=torch.int64, device=dev)
        no = torch.zeros(F, dtype=torch.bool, device=dev)
        t_sc, t_cur, t_sw, t_mb = [], [], [], []
        for k in range(meta.n_bounds + 1):
            scores = cc["base_scores"][k][None].expand(F, C)
            if meta.mode_backlog and k > 0:
                scores = scores + penalty(wait_dec[k], rows_gw_of(cur),
                                          rows_ex_of(cur))
            best = torch.argmin(scores, dim=1)
            if k == 0:
                # The initial placement is free: no gates.
                nxt, switched = best, no
                mb = torch.zeros(F, dtype=f64, device=dev)
            else:
                sc_cur = scores[f_i, cur]
                gain = sc_cur - scores[f_i, best]
                moved = cc["bytes_mat"][cur, best]
                gate = meta.hysteresis * sc_cur + moved * cc["mig_w"] / 1e6
                switched = (best != cur) & (gain > gate)
                nxt = torch.where(switched, best, cur)
                mb = torch.where(switched, moved, 0.0)
            dk = cc["decide_mask"][:, k]
            cur = torch.where(dk, nxt, cur)
            t_sc.append(scores)
            t_cur.append(cur)
            t_sw.append(switched & dk)
            t_mb.append(torch.where(dk, mb, 0.0))
        # Slots past the walk keep the last decision.
        cols = t_cur + [cur] * (meta.n_slots - (meta.n_bounds + 1))
        telem = dict(scores=torch.stack(t_sc, dim=1),
                     chosen=torch.stack(t_cur, dim=1),
                     switched=torch.stack(t_sw, dim=1),
                     mig_bytes=torch.stack(t_mb, dim=1))
        mark("decide")
        return torch.stack(cols, dim=1), telem

    mi = torch.arange(M, device=dev)[None]
    ri = torch.arange(R, device=dev)[None]

    def eval_consts(sp):
        # The schedule row's tables: per token and per request, the
        # candidate tables gathered by the decided plan of the token's
        # slot (P = 1, F-leading).
        pt = sp[:, cc["slot_tok"]]                           # (F, M)
        pr = pt[:, :R]
        eq = {k: q[k] for k in ("dt", "cap", "cap32", "dt32", "gw_service",
                                "arrival_s", "first_tok", "tok_req",
                                "last_tok")}
        eq.update(eff_layer=q["eff_layer"][pt, mi][:, None],
                  tok_base=q["tok_base"][pt, mi][:, None],
                  ingress_extra0=q["ingress_extra0"][pr, ri][:, None],
                  gw_rows=cc["gw_srow"][pt, mi][:, None],
                  ex_rows=cc["ex_srow"][pt, mi][:, None],
                  gw_b0=q["gw_b0"][pt, mi][:, None],
                  gw_fin0=q["gw_fin0"][pt, mi][:, None],
                  ex_b0=q["ex_b0"][pt, mi][:, None],
                  ex_fin0=q["ex_fin0"][pt, mi][:, None])
        if meta.n_mig_chunks and meta.mig_bounds:
            # The decided switches' migration background load: each
            # (incumbent, successor) pair's sequential-sum table at the
            # boundary's bins, in boundary order.
            plane = torch.zeros((F, SRs, T), dtype=f64, device=dev)
            for prev_s, cur_s, b0 in meta.mig_bounds:
                pv = cc["mig_plane"][:, sp[:, prev_s], sp[:, cur_s]]
                for j in range(meta.n_mig_chunks):
                    col = min(b0 + j, T - 1)
                    plane[:, :, col] = plane[:, :, col] + pv[j]
            eq["mig_dense_f"] = plane
        if meta.adm_on:
            # The schedule row's admission anchors, re-derived from the
            # decided plan of each request (_build_admission_tables'
            # quantiles), and its station maps per (slot, entry).
            G = q["ttft0"].shape[-1]
            ok = cc["adm_ok0"][pr, ri]                       # (F, R)
            bt = cc["adm_base_ttft"][pr, ri]
            overall = masked_quantile(bt, ok, meta.ref_q)
            selg = ok[:, None, :] & (
                cc["adm_station"][None, None, :]
                == torch.arange(G, device=dev)[None, :, None])
            per_g = masked_quantile(bt[:, None].expand(F, G, R), selg,
                                    meta.ref_q)
            ttft0 = torch.where(selg.any(dim=2), per_g, overall[:, None])
            pd = pt[:, R:]
            ni = torch.arange(M - R, device=dev)[None]
            tpot0 = masked_quantile(cc["adm_dec_vals"][pd, ni],
                                    cc["adm_dec_ok"][pd, ni], meta.ref_q)
            n_slots = cc["gw_srow_slot"].shape[1]
            si = torch.arange(n_slots, device=dev)[:, None]
            idx = q["gw_rows_slot"].dtype
            kw = dict(q["adm_kw"])
            if kw["pid"] is not None:
                # Per-plan gains are refused on this path: unit gain.
                kw["pid"] = dict(kw["pid"], gain=torch.ones(
                    1, dtype=f32, device=dev))
            eq.update(
                ttft0=ttft0[:, None].to(f32), tpot0=tpot0[:, None].to(f32),
                ctrl=q["ctrl"], seg=q["seg"], n_ctrl=q["n_ctrl"],
                slot_of_bin=q["slot_of_bin"],
                gw_rows_slot=cc["gw_srow_slot"][sp.T, si][:, :, None]
                .to(idx),
                exp_rows_slot=cc["ex_srow_slot"][sp.T, si][:, :, None]
                .to(idx),
                att_bin=q["att_bin"], att_station=q["att_station"],
                adm_u=q["adm_u"], adm_kw=kw,
                att_feasible=q["att_feasible"].permute(0, 2, 1)[pr, ri]
                .permute(0, 2, 1)[:, None],
                att_extra=q["att_extra"].permute(0, 2, 1)[pr, ri]
                .permute(0, 2, 1)[:, None])
        mark("eval_consts")
        return eq

    # The gated table of every entry: the event-major chunk table of the
    # candidates, regrouped by schedule row (stably, so each cell keeps
    # its event order), one copy an entry, F-major.
    n_gate = cc["ch_work"].shape[0]
    fcol = f_i[:, None]
    ech = dict(src=(fcol * (2 * M * L) + cc["ch_local"][None]).reshape(-1),
               offs=cc["ch_offs"].repeat(F),
               fprow=(fcol * SRs + cc["ch_srow"][None]).reshape(-1),
               row_ptr=torch.cat([
                   (fcol * n_gate + cc["ch_row_ptr"][None, :-1]).reshape(-1),
                   torch.full((1,), F * n_gate, dtype=torch.int64,
                              device=dev)]))
    if meta.adm_on:
        ech["fpr"] = (fcol * R + cc["ch_req"][None]).reshape(-1)
    bins0 = cc["ch_bins0"].repeat(F)
    work_fin0 = cc["ch_work"] * cc["ch_fin0"]

    def eval_launch(sp):
        # Each chunk deposits iff its plan is the decided plan of its
        # request's slot: the 0/1 gate multiplies its value (the zeros
        # add nothing to an f64 sum that starts at +0.0).
        eq = eval_consts(sp)
        gate = (sp[:, cc["ch_slot"]] == cc["ch_plan"][None]).to(f64)
        ech["work"] = (cc["ch_work"][None] * gate).reshape(-1)
        v0 = (work_fin0[None] * gate).reshape(-1)
        plane0 = deposit(ech["fprow"], bins0, v0, F * SRs, T,
                         row_ptr=ech["row_ptr"]).reshape(F, SRs, T)
        if "mig_dense_f" in eq:
            plane0 = plane0 + eq["mig_dense_f"]
        ev = _fleet_fixed_point(
            eq, ech, plane0.to(f32), plane0.sum(dim=2), meta.n_iter, T,
            SRs, True, ttft_target, tpot_target)
        wait_dec = ev.pop("wait")[dbins]                      # (K, F, SRs)
        mark("eval")
        return ev, wait_dec

    # Round 1 decides on the probe's backlog, each cell reading its
    # incumbent's rows; later rounds on the schedule row's own backlog.
    sp, telem = decide(probe_wait, lambda cur: cc["pen1_gw"][cur],
                       lambda cur: cc["pen1_ex"][cur])
    ev, ev_wait = eval_launch(sp)
    for _ in range(meta.n_rounds - 1):
        sp, telem = decide(ev_wait, lambda cur: cc["pen2_gw"][None],
                           lambda cur: cc["pen2_ex"][None])
        ev, ev_wait = eval_launch(sp)
    return dict(slot_plan=sp, telem=telem, probe=probe,
                sched={k: ev[k] for k in _CTRL_KEEP})


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

    With a ground segment requests enter through their gateway's best
    visible satellite (uplink and ingress hop billed in TTFT); under an
    AIMD or PID ``qcfg.admission`` construction also builds the
    gateway-retry attempt tables and the controller's zero-load anchors,
    and every run resolves per-request admission between fixed-point
    iterations from the controller's trace (see :mod:`.admission`).
    With ``batching`` (a :class:`~.batching.BatchingConfig`) the decode
    chunks also carry their decode work and visits, and every path runs
    the batching law; with ``probes`` (a
    :class:`~repro_torch.obs.probes.ProbeConfig`) every ``run`` and
    ``run_many`` leaves its final iteration's telemetry in
    ``last_probes`` (a :class:`~repro_torch.obs.probes.ProbeRecord`).
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
        ground: GroundSegment | None = None,
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

        Arguments as the reference's ``FleetSim``.
        """
        _check_config(batching, BatchingConfig, "batching")
        _check_config(probes, ProbeConfig, "probes")
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

        # --- ingress mapping ----------------------------------------------
        if batch is None:
            batch = ScheduleBatch.from_schedules(self.schedules, topo,
                                                 eta=eta)
        self.batch = batch
        if ground is not None:
            ing_sat, uplink = ground.for_requests(slot_r, requests.station)
            reachable = ing_sat >= 0
            ing_off = schedule_ingress_offsets(
                batch, slot_r, np.where(reachable, ing_sat, 0))
            ing_off = np.where(reachable[None, :], ing_off, np.inf)
        else:
            uplink = np.zeros(R)
            ing_off = np.zeros((P, R))
        self.fail_ingress = ~np.isfinite(ing_off)                 # (P, R)
        self.ingress_extra = uplink[None, :] + np.where(
            self.fail_ingress, 0.0, ing_off)                      # (P, R)

        # --- engine pass: base (zero-load) per-token latencies -------------
        svc = resolve_service_model(service_model, workload, compute)
        self.service_model = svc
        # Continuous-batching statics: the padded speedup table (from the
        # service model's batch-size-dependent decode rates), the
        # KV-bounded batch cap and the occupancy window in bins.
        self.batching = batching
        if batching is not None:
            self._batch_table = batching.resolve_table(svc, ctx_len)
            self._batch_cap = float(batching.b_cap)
            self._batch_window = batching.window_bins(qcfg.dt_s)
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
        self._chunk_pr = self.ev_chunk_plan * R + self.ev_chunk_req
        if batching is not None:
            # Continuous-batching chunk channels: decode-side events (the
            # decode tokens' gateway visits and their expert block) carry
            # their work in ``wdec`` and one token visit per event in
            # ``cntw`` (a chunk holds work/ev_work of its event's visit);
            # prefill blocks batch over their own prompt and count zero.
            ev_dec = np.concatenate([
                np.broadcast_to((np.arange(M) >= R)[:, None],
                                (M, L)).ravel(),
                np.ones(N * L * K, dtype=bool),
                np.zeros(R * L * n_exp, dtype=bool),
            ]).astype(np.float64)                                 # (E,)
            dec_ch = np.broadcast_to(ev_dec[None, :],
                                     ev_work.shape).ravel()[self._rep]
            wf = w_flat[self._rep]
            self._chunk_wdec = self.ev_chunk_work * dec_ch
            self._chunk_cntw = np.where(
                wf > 0.0,
                self.ev_chunk_work / np.where(wf > 0.0, wf, 1.0),
                0.0) * dec_ch
        self._dev: dict | None = None
        self._ctrl: dict | None = None       # _ctrl_tables, built lazily
        self._ctrl_dev: dict | None = None   # their device copies

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

        # --- admission controller precompute ------------------------------
        acfg = qcfg.admission
        self.admission_on = acfg is not None \
            and acfg.policy in ("aimd", "pid")
        if self.admission_on:
            if acfg.policy == "pid" and acfg.gain_scale is not None \
                    and len(acfg.gain_scale) != len(self.schedules):
                raise ValueError(
                    f"gain_scale has {len(acfg.gain_scale)} entries for "
                    f"{len(self.schedules)} plans")
            self._build_admission_tables(acfg, ground, slot_r, rng)
        self._build_row_map()
        self._build_fused_tables()

        # Filled by ``run``: the last fleet scan's backlog (see last_wait).
        self._last_wait: np.ndarray | None = None
        self._last_wait_rows: torch.Tensor | None = None
        # Telemetry: filled by every launch when ``probes`` is set.
        self.probes = probes
        self.last_probes: ProbeRecord | None = None

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

    def _build_admission_tables(self, acfg, ground: GroundSegment | None,
                                slot_r: np.ndarray,
                                rng: np.random.Generator) -> None:
        """The gateway-retry attempt tables and the controller's zero-load
        anchors (the reference's precompute, host numpy).

        Per attempt a (0 = the original gateway, a >= 1 = the a-th best
        alternative from :meth:`GroundSegment.retry_stations`): target
        gateway, ingress latency (a * backoff + terrestrial forward +
        uplink + ingress hop, through the first rank of the gateway's
        visibility table that the plan can route) and per-plan
        feasibility.  Without an a-th alternative, attempt a retries the
        origin after the backoff.  Then the attempts' bins, one uniform
        per (attempt, request) shared by every plan, the TTFT/TPOT
        anchors at ``reference_quantile`` and the per-bin station maps of
        the controller's qhat.
        """
        req = self.requests
        P, R = self.n_plans, self.n_requests
        A = acfg.n_attempts
        self.n_gw_stations = ground.n_stations if ground is not None else 1

        # Without a ground segment there is a single logical gateway.
        station = req.station if ground is not None \
            else np.zeros(R, dtype=np.int64)
        st_att = np.tile(station, (A, 1))                         # (A, R)
        alt_ok = np.zeros((A, R), dtype=bool)
        alt_ok[0] = True
        if ground is not None and acfg.max_retries > 0:
            alts = ground.retry_stations(slot_r, req.station,
                                         acfg.max_retries)        # (R, n_alt)
            n_alt = alts.shape[1]
            for a in range(1, min(A, n_alt + 1)):
                st_att[a] = alts[:, a - 1]
                alt_ok[a] = True

        extra = np.empty((A, P, R))
        feas = np.zeros((A, P, R), dtype=bool)
        extra[0] = self.ingress_extra
        feas[0] = ~self.fail_ingress
        for a in range(1, A):
            if ground is None or not alt_ok[a].any():
                extra[a] = self.ingress_extra + a * acfg.retry_backoff_s
                feas[a] = feas[0]
                continue
            gdelay = ground.ground_delay_s[req.station, st_att[a]]
            ing_r = ground.ingress_ranked[slot_r, st_att[a]]      # (R, K)
            up_r = ground.uplink_ranked_s[slot_r, st_att[a]]      # (R, K)
            best = np.zeros((P, R))
            best_ok = np.zeros((P, R), dtype=bool)
            for k in range(ground.n_ranked):
                reachable = ing_r[:, k] >= 0
                off = schedule_ingress_offsets(
                    self.batch, slot_r, np.where(reachable, ing_r[:, k], 0))
                ok = reachable[None, :] & np.isfinite(off)
                take = ok & ~best_ok
                best = np.where(take, up_r[None, :, k] + off, best)
                best_ok |= ok
            extra[a] = (a * acfg.retry_backoff_s + gdelay)[None, :] \
                + np.where(best_ok, best, 0.0)
            feas[a] = best_ok & alt_ok[a][None, :]
        self._att_station = st_att
        self._att_extra = extra
        self._att_feasible = feas
        # Attempt a is evaluated at the gateway it targets, after the
        # backoff + terrestrial forward but before the uplink.
        t_att = req.arrival_s[None, :] + np.arange(A)[:, None] \
            * acfg.retry_backoff_s
        if ground is not None:
            t_att = t_att + ground.ground_delay_s[req.station, st_att]
        self._att_bin = np.clip((t_att / self.qcfg.dt_s).astype(np.int64),
                                0, self.n_bins - 1)
        # Common random numbers: one uniform per (attempt, request).
        self._adm_u = rng.random((A, R))

        base_ttft = self.ingress_extra + self.tok_base[:, :R]     # (P, R)
        ok = feas[0] & ~_segment_any(self.nan_tok[:, R:], self.tok_req, R) \
            & ~self.nan_tok[:, :R]
        self._adm_ttft0 = _station_quantile(
            base_ttft, ok, station, self.n_gw_stations,
            acfg.reference_quantile)                              # (P, G)
        dec_ok = np.isfinite(self.tok_base[:, R:]) & ~self.nan_tok[:, R:]
        self._adm_tpot0 = np.array([
            np.quantile(self.tok_base[i, R:][dec_ok[i]],
                        acfg.reference_quantile)
            if dec_ok[i].any() else 0.0 for i in range(P)])        # (P,)
        # The joint control plane re-derives the schedule row's anchors
        # on the device from these masked tables (gathered per decided
        # plan).
        self._adm_station = station
        self._adm_ok0 = ok
        self._adm_base_ttft = base_ttft
        self._adm_dec_ok = dec_ok

        # Per time bin, the bin's topology slot selects each plan's
        # gateway chain and expert satellites (qhat follows the schedule).
        slot_of_bin = slot_of_time(np.arange(self.n_bins) * self.qcfg.dt_s,
                                   self.qcfg.slot_period_s,
                                   self.n_topo_slots)
        self._adm_slot_of_bin = slot_of_bin
        self._adm_gw_idx = np.ascontiguousarray(np.moveaxis(
            self.gateways_slot[:, slot_of_bin], 1, 0)).astype(np.int32)
        self._adm_exp_idx = np.ascontiguousarray(np.moveaxis(
            self.expert_sats_slot[:, slot_of_bin], 1, 0)).reshape(
                self.n_bins, P, -1).astype(np.int32)

    def _build_row_map(self) -> None:
        """Compact the (plan, satellite) rows the fused path keeps dense:
        only rows that can receive a deposit or be read (the admission
        controller's stations included); every other station carries
        exactly zero backlog, so dropping it is exact."""
        P, S, T = self.n_plans, self.n_stations, self.n_bins
        p_idx = np.arange(P)[:, None, None]
        gw_rows = p_idx * S + self.gather_gw_station              # (P,M,L)
        ex_rows = p_idx[..., None] * S + self.gather_exp_station
        used = [self._chunk_row, gw_rows.ravel(), ex_rows.ravel()]
        if self._mig_flat.size:
            used.append(self._mig_flat // T)
        if self.admission_on:
            # The stations of the slots the bins fall in: the reference's
            # per-bin maps hold exactly these values.
            slots = np.unique(self._adm_slot_of_bin)
            used.append((p_idx * S + self.gateways_slot[:, slots]).ravel())
            used.append((p_idx[..., None] * S
                         + self.expert_sats_slot[:, slots]).ravel())
        rows = np.unique(np.concatenate(used))
        inv = np.full(P * S, -1, dtype=np.int64)
        inv[rows] = np.arange(rows.size)
        self._active_rows = rows
        self._row_inv = inv
        self.n_rows = int(rows.size)
        self._chunk_rowc = inv[self._chunk_row].astype(np.int32)
        self._gw_rowc = inv[gw_rows]                              # (P,M,L)
        self._ex_rowc = inv[ex_rows]                              # (P,M,L,K)
        if self.admission_on:
            # The controller's compact rows per topology slot, (N_T, P, L)
            # and (N_T, P, L * I): the reference's per-bin maps are these
            # at each bin's slot.
            self._adm_gw_rowc_slot = np.moveaxis(
                inv[p_idx * S + self.gateways_slot], 1, 0)
            self._adm_exp_rowc_slot = np.moveaxis(
                inv[p_idx[..., None] * S + self.expert_sats_slot], 1, 0
            ).reshape(self.n_topo_slots, P, -1)

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
        # In event order too: the joint control plane's gated table.
        self._chunk_bins0 = bins0
        self._chunk_fin0 = fin0[self._rep]
        perm = np.argsort(self._chunk_rowc, kind="stable")
        self._f_src = self._chunk_src[perm]
        self._f_offs = self._offs[perm]
        self._f_work = self.ev_chunk_work[perm]
        self._f_rowc = self._chunk_rowc[perm]
        self._f_pr = self._chunk_pr[perm]
        self._f_req = self.ev_chunk_req[perm]
        self._f_bins0 = bins0[perm]
        self._f_fin0 = fin0[self._rep][perm]
        if self.batching is not None:
            self._f_wdec = self._chunk_wdec[perm]
            self._f_cntw = self._chunk_cntw[perm]
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

    def _bin_work_planes(self, layer_arr, exp_arr, active2d):
        """Decode-work and occupancy-count planes (P, S, T) for the host
        path's batching law: :meth:`_bin_work`'s bins, the decode-side
        chunk channels, no migration background (it is not batchable
        decode work)."""
        P = self.n_plans
        S, T = self.n_stations, self.n_bins
        ev_time = self._event_times(layer_arr, exp_arr)           # (P*E,)
        base_bin, finite = self._to_bins(ev_time)
        bins = np.minimum(base_bin[self._rep] + self._offs, T - 1)
        act = finite[self._rep] \
            * active2d[self.ev_chunk_plan, self.ev_chunk_req]
        flat = (self.ev_chunk_plan * S + self.ev_chunk_station) * T + bins
        wdec = np.bincount(flat, weights=self._chunk_wdec * act,
                           minlength=P * S * T).reshape(P, S, T)
        cnt = np.bincount(flat, weights=self._chunk_cntw * act,
                          minlength=P * S * T).reshape(P, S, T)
        return wdec, cnt

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
        observed at wall-clock ``t_s`` in the last ``run`` (read from the
        device's compact rows when ``last_wait`` has not been expanded)."""
        b = min(int(t_s / self.qcfg.dt_s), self.n_bins - 1)
        if self._last_wait is None and self._last_wait_rows is not None:
            row = self._last_wait_rows[b].cpu().numpy()
            return self._expand_rows(row)[plan]
        if self.last_wait is None:
            return np.zeros(self.n_stations)
        return self.last_wait[plan, :, b]

    # ----------------------------------------------------------------- #

    def _device_tables(self) -> dict:
        """The fused fixed point's rate-independent tables on the
        simulator's device (built once): the zero-load schedule tensors
        in float64, the row and bin indices, the densified migration
        background load, and under admission the controller's tables
        (float32 anchors, control flags, compact station rows per slot)
        and the attempt tables."""
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
        if self.admission_on:
            acfg = qcfg.admission
            # The controller's station tables: int32 for the card's
            # admission_window, int64 for the CPU's gathers.
            idx = torch.int32 if dev.type == "cuda" else torch.int64
            ctrl = put(control_bin_flags(self.n_bins, qcfg.dt_s,
                                         acfg.interval_s))
            seg, n_ctrl = control_segments(ctrl)
            d.update(
                ttft0=put(self._adm_ttft0.astype(np.float32)),
                tpot0=put(self._adm_tpot0.astype(np.float32)),
                ctrl=ctrl, seg=seg.to(idx), n_ctrl=n_ctrl,
                slot_of_bin=put(self._adm_slot_of_bin, idx),
                gw_rows_slot=put(self._adm_gw_rowc_slot, idx),
                exp_rows_slot=put(self._adm_exp_rowc_slot, idx),
                att_bin=put(self._att_bin, torch.int64),
                att_station=put(self._att_station, torch.int64),
                att_feasible=put(np.moveaxis(self._att_feasible, 1, 0)),
                att_extra=put(np.moveaxis(self._att_extra, 0, 1),
                              torch.float64),
                adm_u=put(self._adm_u, torch.float64),
                adm_kw=dict(increase=acfg.increase, decrease=acfg.decrease,
                            admit_min=acfg.admit_min, pid=None),
            )
            if acfg.policy == "pid":
                gain = np.ones(self.n_plans) if acfg.gain_scale is None \
                    else np.asarray(acfg.gain_scale, dtype=np.float64)
                d["adm_kw"]["pid"] = dict(
                    kp=acfg.kp, ki=acfg.ki, kd=acfg.kd,
                    gain=put(gain.astype(np.float32)))
        self._dev = d
        return d

    def chunk_table(self, masks: np.ndarray) -> dict:
        """The compacted chunk table of one launch over (F, R) masks, as
        host arrays (the reference's ``_launch`` compaction, padding
        included), plus ``row_ptr``: the table is grouped by ``fprow``
        (F-major, then the static row order) up to the padding, and row
        r owns entries [row_ptr[r], row_ptr[r+1]).  Iteration 1's
        deposit is ``flat0`` (cells of the (F * rows * T) plane) with
        weights ``work0``; under batching also ``wdec0`` and ``cnt0``,
        and the table gains ``wdec`` and ``cntw``."""
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
        fin0 = self._f_fin0[cid]
        out = dict(src=src, offs=offs, work=work, fprow=fprow,
                   row_ptr=row_ptr, n=n, flat0=flat0,
                   work0=self._f_work[cid] * fin0)
        if self.batching is not None:
            for name, table in (("wdec", self._f_wdec),
                                ("cntw", self._f_cntw)):
                padded = np.zeros(n_pad)
                padded[:n] = table[cid]
                out[name] = padded
            out["wdec0"] = self._f_wdec[cid] * fin0
            out["cnt0"] = self._f_cntw[cid] * fin0
        if self.admission_on:
            fpr = np.zeros(n_pad, dtype=np.int64)
            fpr[:n] = f_id * (self.n_plans * self.n_requests) \
                + self._f_pr[cid]
            out["fpr"] = fpr
        return out

    def _ctrl_tables(self) -> dict:
        """Host precompute of the joint control plane (lazy, cached; the
        reference's, plus the gated table's row grouping).

        Independent of the controller's configuration: the schedule row's
        compact station universe, the gated chunk table, the decide walk's
        penalty row maps, the decision bins, the migration tables and
        under admission the anchors' inputs and per-slot station maps.
        """
        if self._ctrl is not None:
            return self._ctrl
        qcfg = self.qcfg
        C, S, T = self.n_plans, self.n_stations, self.n_bins
        M, L, R = self.n_tokens, self.n_layers, self.n_requests
        N = self.n_decode_tokens
        K = self.activation.top_k
        dt, period = qcfg.dt_s, qcfg.slot_period_s
        n_slots = self.n_topo_slots

        # The schedule row's station universe: every satellite it can
        # deposit on, gather from, observe (admission maps, penalty) or
        # receive weights at, over the whole pool; rows of it that take
        # no work carry exactly zero, so the compaction is exact.
        gw_all = np.stack([np.asarray(p.gateways) for p in self.plans])
        ex_all = np.stack([np.asarray(p.expert_sats) for p in self.plans])
        used = [self.ev_chunk_station.ravel(), self.gather_gw_station.ravel(),
                self.gather_exp_station.ravel(), gw_all.ravel(),
                ex_all.ravel()]
        if self.admission_on:
            slots = np.unique(self._adm_slot_of_bin)
            used += [self.gateways_slot[:, slots].ravel(),
                     self.expert_sats_slot[:, slots].ravel()]
        srows = np.unique(np.concatenate(
            [np.asarray(u, dtype=np.int64) for u in used]))
        srow_inv = np.full(S, -1, dtype=np.int64)
        srow_inv[srows] = np.arange(srows.size)
        SRs = int(srows.size)

        # The gated chunk table: the candidates' chunks in event order,
        # plan within event (only the decided plan's chunks of an event
        # deposit, so each (row, bin) cell sums in a host evaluation
        # simulator's order), then grouped by schedule row with a stable
        # sort, which keeps each cell's order: the grouping the CUDA
        # deposit reads through row_ptr.
        E = self._n_events // C
        gw1 = np.arange(M)[:, None] * L + np.arange(L)[None, :]
        exp1 = M * L + gw1
        ev1 = np.concatenate([
            gw1.ravel(),
            np.broadcast_to(exp1[R:, :, None], (N, L, K)).ravel(),
            np.broadcast_to(exp1[:R, :, None],
                            (R, L, ex_all.shape[2])).ravel()])
        ev_local = self._rep % E
        perm = np.lexsort((self.ev_chunk_plan, ev_local))
        srow_ev = srow_inv[self.ev_chunk_station[perm]]
        perm = perm[np.argsort(srow_ev, kind="stable")]
        ch_srow = srow_inv[self.ev_chunk_station[perm]]
        ct = dict(
            srows=srows, n_rows_sched=SRs,
            ch_local=ev1[ev_local[perm]],
            ch_work=self.ev_chunk_work[perm],
            ch_offs=self._offs[perm],
            ch_srow=ch_srow,
            ch_row_ptr=np.searchsorted(ch_srow, np.arange(SRs + 1),
                                       side="left"),
            ch_plan=self.ev_chunk_plan[perm],
            ch_slot=self.slots[self.ev_chunk_req[perm]],
            ch_req=self.ev_chunk_req[perm],
            ch_bins0=self._chunk_bins0[perm],
            ch_fin0=self._chunk_fin0[perm].astype(np.float64),
        )

        # Penalty row maps.  Round 1 reads the probe's compact (plan,
        # satellite) rows of each incumbent (a dropped row reads the
        # appended zero column, index n_rows); later rounds read the
        # schedule row's universe.
        SR = self.n_rows
        pen1_gw = np.empty((C, C, L), dtype=np.int64)
        pen1_ex = np.empty((C, C) + ex_all.shape[1:], dtype=np.int64)
        for cur in range(C):
            rg = self._row_inv[cur * S + gw_all]
            pen1_gw[cur] = np.where(rg >= 0, rg, SR)
            re_ = self._row_inv[cur * S + ex_all]
            pen1_ex[cur] = np.where(re_ >= 0, re_, SR)
        ct.update(pen1_gw=pen1_gw, pen1_ex=pen1_ex,
                  pen2_gw=srow_inv[gw_all], pen2_ex=srow_inv[ex_all],
                  gw_srow=srow_inv[self.gather_gw_station],
                  ex_srow=srow_inv[self.gather_exp_station])

        # The decision walk's boundaries and observation bins (as
        # replan.build_replan_schedule walks them).
        horizon = T * dt
        n_bounds = min(int(np.floor(max(horizon, 0.0) / period)),
                       n_slots - 1)
        ct["n_bounds"] = n_bounds
        ct["decide_bins"] = tuple(
            min(int((k * period) / dt), T - 1) for k in range(n_bounds + 1))

        # Migration: all-pairs switch counts (the decide gate's prices)
        # and the background-load table, *sequential* repeated sums of a
        # chunk's occupancy (n experts landing on one satellite deposit w
        # n times, as the host bincount adds them).
        n_moved, dest = migration_matrix(self.plans, 1.0, S)
        ct["n_moved"] = n_moved
        sec = (qcfg.migration_bytes_per_expert * 8.0
               / (qcfg.migration_rate_gbps * 1e9))
        if sec > 0.0:
            n_chm = max(int(np.ceil(sec / dt)), 1)
            w_prof = np.minimum(sec - np.arange(n_chm) * dt, dt)
        else:
            w_prof = np.zeros(0)
        max_cnt = int(dest.max())
        rep = np.zeros((len(w_prof), max_cnt + 1))
        for j, w in enumerate(w_prof):
            for n in range(1, max_cnt + 1):
                rep[j, n] = rep[j, n - 1] + w
        ct["n_mig_chunks"] = int(len(w_prof))
        ct["mig_plane"] = rep[:, dest[:, :, srows].astype(np.int64)]
        nbm = int(np.floor(horizon / period))
        ct["mig_bounds"] = tuple(
            (int((k - 1) % n_slots), int(k % n_slots),
             int((k * period) / dt)) for k in range(1, nbm + 1))

        if self.admission_on:
            # The anchors' masked inputs and the station maps per slot
            # (the reference's per-bin maps are these at each bin's slot).
            ct.update(
                adm_ok0=self._adm_ok0, adm_base_ttft=self._adm_base_ttft,
                adm_station=self._adm_station, adm_dec_ok=self._adm_dec_ok,
                adm_dec_vals=self.tok_base[:, R:],
                gw_srow_slot=srow_inv[self.gateways_slot],
                ex_srow_slot=srow_inv[self.expert_sats_slot].reshape(
                    C, n_slots, -1))
        self._ctrl = ct
        return ct

    def _ctrl_device(self) -> dict:
        """The arrays of :meth:`_ctrl_tables` that the control plane reads,
        on the simulator's device (built once)."""
        if self._ctrl_dev is not None:
            return self._ctrl_dev
        ct = self._ctrl_tables()
        names = ["ch_local", "ch_work", "ch_offs", "ch_srow", "ch_row_ptr",
                 "ch_plan", "ch_slot", "ch_bins0", "ch_fin0", "pen1_gw",
                 "pen1_ex", "pen2_gw", "pen2_ex", "gw_srow", "ex_srow"]
        if ct["n_mig_chunks"] and ct["mig_bounds"]:
            names.append("mig_plane")
        if self.admission_on:
            names += ["ch_req", "adm_ok0", "adm_base_ttft", "adm_station",
                      "adm_dec_ok", "adm_dec_vals", "gw_srow_slot",
                      "ex_srow_slot"]
        self._ctrl_dev = {
            k: torch.from_numpy(np.array(ct[k])).to(self.device)
            for k in names}
        self._ctrl_dev["slot_tok"] = torch.from_numpy(
            np.array(self.slots)).to(self.device)
        return self._ctrl_dev

    def _targets(self, n_f: int, ttft_targets, tpot_targets):
        """(F,) float32 margin-scaled TTFT and TPOT targets of one launch
        on the device (the configuration's, or the given sweep's)."""
        acfg = self.qcfg.admission
        m = acfg.target_margin
        tt = (np.full(n_f, m * acfg.ttft_target_s) if ttft_targets is None
              else m * np.asarray(ttft_targets, dtype=np.float64))
        tp = (np.full(n_f, m * acfg.tpot_target_s) if tpot_targets is None
              else m * np.asarray(tpot_targets, dtype=np.float64))
        if tt.shape != (n_f,) or tp.shape != (n_f,):
            raise ValueError(f"latency targets must be ({n_f},), one per "
                             "activity mask")
        return tuple(torch.from_numpy(x.astype(np.float32)).to(self.device)
                     for x in (tt, tp))

    def _probe_tables(self, bins: np.ndarray) -> dict:
        """The fixed point's ``probe`` argument for the recorded ``bins``
        (:func:`_probe_channels`), on the device.  Under admission each
        bin's control window runs from the bin after the previous
        control bin up to it: ``win_idx`` lists those bins (the recorded
        bin last, shorter windows padded with it), ``win_ctrl`` flags
        control bins (their window restarts: 0) and ``state_idx`` is the
        controller state after the bin (``seg + ctrl``)."""
        dev = self.device
        out = dict(bins=torch.from_numpy(bins).to(dev))
        if not self.admission_on:
            return out
        ctrl = control_bin_flags(self.n_bins, self.qcfg.dt_s,
                                 self.qcfg.admission.interval_s)
        seg = np.cumsum(ctrl) - ctrl
        ctrl_pos = np.flatnonzero(ctrl)
        start = np.where(seg[bins] > 0,
                         ctrl_pos[np.maximum(seg[bins] - 1, 0)] + 1
                         if ctrl_pos.size else 0, 0)
        width = int((bins - start).max()) + 1 if bins.size else 1
        idx = np.minimum(start[:, None] + np.arange(width)[None, :],
                         bins[:, None])
        out.update(win_idx=torch.from_numpy(idx).to(dev),
                   win_ctrl=torch.from_numpy(ctrl[bins]).to(dev),
                   state_idx=torch.from_numpy(
                       seg[bins] + ctrl[bins]).to(dev))
        return out

    def _record_probes(self, out: dict, capacity: int, stride: int,
                       slots: np.ndarray) -> None:
        """Set ``last_probes`` from a probed launch's outputs (popped from
        ``out``): the channels at the recorded bins go into the ring
        buffers at their ``slots``, which :meth:`ProbeRecord.from_launch`
        unwraps as it unwraps the reference's."""
        chans = {k: v.cpu().numpy() for k, v in out.pop("probe").items()}
        raw = make_buffers(capacity, chans["rows"].shape[2], self.n_rows,
                           (self.n_plans, self.n_gw_stations)
                           if self.admission_on else None,
                           n_row_channels=chans["rows"].shape[1])
        for k, v in chans.items():
            raw[k][slots] = v
        self.last_probes = ProbeRecord.from_launch(
            raw, out.pop("probe_gw_wait").cpu().numpy(),
            out.pop("probe_ex_wait").cpu().numpy(), self.qcfg.dt_s,
            capacity, stride, self.n_bins, self._expand_rows)

    def _launch(self, masks: np.ndarray, ttft_targets, tpot_targets,
                want_wait: bool) -> dict:
        """One fused fixed point over the leading sweep axis F.

        The request-activity masks fold into the compacted chunk table
        (only active chunks are deposited); iteration 1's work plane is
        one host ``np.bincount`` over the static zero-wait bins, as in
        the reference (under batching three, and the law on the host in
        float64).  ``ttft_targets``/``tpot_targets``: optional (F,) raw
        targets of an admission sweep (the margin is applied here).
        Returns the :func:`_fleet_fixed_point` outputs as host arrays,
        each with a leading F axis; ``wait``, when asked for, stays a
        device tensor.  With probes on, sets ``last_probes``.
        """
        F = masks.shape[0]
        targets = (self._targets(F, ttft_targets, tpot_targets)
                   if self.admission_on else (None, None))
        T, SR = self.n_bins, self.n_rows
        n_iter = max(1, self.qcfg.iterations)
        ct = self.chunk_table(masks)

        def plane(weights):
            # astype: the bincount of an empty chunk set is int64.
            return np.bincount(ct["flat0"], weights=weights,
                               minlength=F * SR * T).reshape(F, SR, T) \
                .astype(np.float64, copy=False)
        plane0 = plane(ct["work0"])
        if self._mig_rm is not None:
            plane0 += self._mig_rm[None]
        work0_sum = plane0.sum(axis=2)                            # (F, SR)
        dev = self.device
        probe = batch = None
        if self.probes is not None:
            p_cap, p_stride = self.probes.resolve(T)
            slots, bins = ring_bins(T, p_cap, p_stride)
            probe = self._probe_tables(bins)
        if self.batching is not None:
            plane0, beff0 = effective_work_np(
                plane0, plane(ct["wdec0"]), plane(ct["cnt0"]),
                self._batch_table, self._batch_cap, self._batch_window)
            batch = dict(table=torch.from_numpy(self._batch_table).to(dev),
                         bcap=self._batch_cap, window=self._batch_window)
            if probe is not None and n_iter == 1:
                batch["beff0_at"] = torch.from_numpy(
                    beff0[:, :, bins].astype(np.float32)).to(dev)
        chunks = {k: torch.from_numpy(ct[k]).to(dev)
                  for k in ("src", "offs", "work", "fprow", "row_ptr", "fpr",
                            "wdec", "cntw")
                  if k in ct}
        out = _fleet_fixed_point(
            self._device_tables(), chunks,
            torch.from_numpy(plane0.astype(np.float32)).to(dev),
            torch.from_numpy(work0_sum).to(dev), n_iter, T, SR, want_wait,
            *targets, batch=batch, probe=probe)
        if probe is not None:
            self._record_probes(out, p_cap, p_stride, slots)
        # The (T, F, rows) wait trace stays on the device (see last_wait).
        return {k: v if k == "wait" else v.cpu().numpy()
                for k, v in out.items()}

    def run(self, active: np.ndarray | None = None,
            zero_load: bool = False,
            kv_slots: int | None = None, *,
            replan=None, replan_rng=None) -> TrafficResult:
        """Simulate with an optional per-request activity mask and return
        per-plan traffic metrics (one fused fixed point on the device).

        ``zero_load`` delegates to the host path (no queueing, no
        admission); ``kv_slots`` overrides the static cap (ignored under
        the admission controller, which replaces it).  ``replan`` (a
        ``replan.ReplanConfig``) runs the joint control plane instead
        (:meth:`run_replan_grid`, one cell) and returns its
        ``ReplanOutcome``; ``replan_rng`` seeds the candidates' base
        scores (default ``np.random.default_rng(0)``).  It composes with
        no other option.
        """
        if replan is not None:
            if active is not None or zero_load or kv_slots is not None:
                raise ValueError(
                    "run(replan=...) composes with no other run() option")
            from .replan import replan_base_scores
            rng = (np.random.default_rng(0) if replan_rng is None
                   else replan_rng)
            scores = replan_base_scores(
                self.plans, self.topo, self.activation, self.workload,
                self.compute, rng, replan, device=self.device)
            return self.run_replan_grid(replan, base_scores=scores)[0]
        if zero_load:
            return self.run_legacy(active, zero_load=True,
                                   kv_slots=kv_slots)
        if active is None:
            active = np.ones(self.n_requests, dtype=bool)
        active = np.asarray(active, dtype=bool)
        out = self._launch(active[None, :], None, None, want_wait=True)
        self.last_wait = None
        self._last_wait_rows = out.pop("wait")[:, 0, :]  # (T, rows), device
        out = {k: v[0] for k, v in out.items()}
        out["work_sum"] = self._expand_rows(out["work_sum"])
        return self._finalize(active, out, self.admission_on, kv_slots)

    def run_many(self, active: np.ndarray | None = None, *,
                 ttft_targets: np.ndarray | None = None,
                 tpot_targets: np.ndarray | None = None,
                 kv_slots: int | None = None,
                 replan=None, replan_rng=None, base_scores=None,
                 cadences=None, mig_weights=None) -> list:
        """Run a whole sweep as one fused fixed point and return one
        :class:`TrafficResult` per entry, in order.

        Args:
            active: (F, R) bool activity masks, one per sweep entry (rows
                may repeat when only the targets vary).
            ttft_targets: Optional (F,) TTFT targets overriding the
                admission configuration's (AIMD/PID runs only).
            tpot_targets: Optional (F,) TPOT targets, same contract.
            kv_slots: Optional static-cap override.
            replan: Optional ``replan.ReplanConfig``: the sweep becomes a
                controller grid (:meth:`run_replan_grid`) over
                ``cadences`` x ``mig_weights`` x the admission targets,
                all requests active, and returns one ``ReplanOutcome`` a
                cell (cadence-major).
            replan_rng: Seeds the base scores when ``base_scores`` is
                None (default ``np.random.default_rng(0)``).
            base_scores: Optional (n_slots, C) base score table
                (``replan.replan_base_scores``).
            cadences, mig_weights: The grid's cadence and migration-price
                axes (they need ``replan``).
        """
        if replan is not None:
            if active is not None or kv_slots is not None:
                raise ValueError(
                    "run_many(replan=...) composes only with the "
                    "target/cadence/migration grid axes")
            if base_scores is None:
                from .replan import replan_base_scores
                rng = (np.random.default_rng(0) if replan_rng is None
                       else replan_rng)
                base_scores = replan_base_scores(
                    self.plans, self.topo, self.activation, self.workload,
                    self.compute, rng, replan, device=self.device)
            return self.run_replan_grid(
                replan, base_scores=base_scores, cadences=cadences,
                mig_weights=mig_weights, ttft_targets=ttft_targets,
                tpot_targets=tpot_targets)
        if cadences is not None or mig_weights is not None \
                or base_scores is not None:
            raise ValueError("controller grid axes need replan=...")
        if active is None:
            raise ValueError("run_many needs (F, R) activity masks")
        masks = np.asarray(active, dtype=bool)
        if masks.ndim != 2 or masks.shape[1] != self.n_requests:
            raise ValueError(f"active must be (F, {self.n_requests})")
        if (ttft_targets is not None or tpot_targets is not None) \
                and not self.admission_on:
            raise ValueError(
                "latency-target sweeps need an AIMD admission config")
        out = self._launch(masks, ttft_targets, tpot_targets,
                           want_wait=False)
        out["work_sum"] = self._expand_rows(out["work_sum"])
        return [self._finalize(masks[f], {k: v[f] for k, v in out.items()},
                               self.admission_on, kv_slots)
                for f in range(masks.shape[0])]

    def run_replan_grid(self, rcfg, *, base_scores, cadences=None,
                        mig_weights=None, ttft_targets=None,
                        tpot_targets=None, stage=None) -> list:
        """The joint control plane over a controller grid, in one call.

        Probe, decide walk and schedule-row evaluation run as one
        :func:`_ctrl_core` call on the simulator's device, batched over
        the grid's cells: cadences x migration prices x admission targets,
        cadence-major.  The host controller (``replan.replan_traffic``)
        stays the semantic anchor; on the CPU this reproduces its
        decisions and served/shed sets bit for bit.  Paths where the host
        controller stays authoritative raise: continuous batching, probe
        rings, calibrated per-satellite service (its decode-batch estimate
        depends on the evaluated pool), candidate pools holding schedules
        and per-plan PID gains.

        Args:
            rcfg: ``ReplanConfig`` (its ``period_slots`` and
                ``migration_weight_s_per_mb`` are the grid axes when none
                are given).
            base_scores: (n_topo_slots, C) backlog-free candidate scores
                per slot (``replan.replan_base_scores``); the decide law
                adds the backlog penalty on the device.
            cadences: Decision cadences in slots (>= 1).
            mig_weights: Migration prices (s/MB, >= 0).
            ttft_targets: Optional admission-target axis (raw seconds,
                zipped with ``tpot_targets``; admission runs only).
            tpot_targets: Optional TPOT targets.
            stage: Optional instrumentation hook of :func:`_ctrl_core`.

        Returns:
            One ``ReplanOutcome`` per cell: the last round's decisions,
            the candidates' rows with the schedule's stitched on, the
            probe's result (backlog mode) and this simulator as ``sim``.
        """
        from .replan import (REPLAN_MODES, ReplanDecision, ReplanOutcome,
                             ReplanReport)

        qcfg = self.qcfg
        acfg = qcfg.admission
        if rcfg.mode not in REPLAN_MODES:
            raise ValueError(f"unknown replan mode: {rcfg.mode!r}")
        if self.batching is not None:
            raise NotImplementedError(
                "joint control plane: continuous batching stays on the "
                "host controller (replan_traffic)")
        if self.probes is not None:
            raise NotImplementedError(
                "joint control plane: probe rings are not recorded on "
                "the control launch — use replan_traffic for probed "
                "rounds")
        if self.service_model.per_satellite:
            raise NotImplementedError(
                "joint control plane: calibrated per-satellite service "
                "recomputes its decode-batch estimate per evaluated "
                "plan pool — the host controller is authoritative")
        if any(not s.is_constant for s in self.schedules):
            raise ValueError(
                "run_replan_grid needs a static candidate pool (plain "
                "plans); schedules cannot be re-decided")
        if (ttft_targets is not None or tpot_targets is not None) \
                and not self.admission_on:
            raise ValueError(
                "admission-target axes need an admission config")
        if self.admission_on and getattr(acfg, "gain_scale", None) \
                is not None:
            raise NotImplementedError(
                "joint control plane: per-plan admission gains are "
                "pool-indexed and do not transfer to the decided "
                "schedule row")

        C = self.n_plans
        n_slots = self.n_topo_slots
        T, R, M = self.n_bins, self.n_requests, self.n_tokens
        bs = np.asarray(base_scores, dtype=np.float64)
        if bs.shape != (n_slots, C):
            raise ValueError(f"base_scores must be ({n_slots}, {C})")
        cads = ([int(rcfg.period_slots)] if cadences is None
                else [int(c) for c in cadences])
        migw = ([float(rcfg.migration_weight_s_per_mb)]
                if mig_weights is None
                else [float(w) for w in mig_weights])
        if any(c < 1 for c in cads):
            raise ValueError("cadences must be >= 1")
        if any(w < 0 for w in migw):
            raise ValueError("migration weights must be >= 0")
        tts = [None] if ttft_targets is None else list(ttft_targets)
        tps = [None] * len(tts) if tpot_targets is None \
            else list(tpot_targets)
        if len(tps) != len(tts):
            raise ValueError("ttft_targets and tpot_targets must zip")
        cells = [(c, w, i) for c in cads for w in migw
                 for i in range(len(tts))]
        F = len(cells)

        if self.admission_on:
            m = acfg.target_margin
            tt = np.array([m * (acfg.ttft_target_s if tts[i] is None
                                else tts[i]) for _, _, i in cells])
            tp = np.array([m * (acfg.tpot_target_s if tps[i] is None
                                else tps[i]) for _, _, i in cells])
        else:
            tt, tp = np.zeros(F), np.zeros(F)

        ct = self._ctrl_tables()
        K1 = ct["n_bounds"] + 1
        dmask = np.zeros((F, K1), dtype=bool)
        for f, (cad, _w, _i) in enumerate(cells):
            for k in range(K1):
                dmask[f, k] = (k == 0) or (rcfg.mode != "off"
                                           and k % cad == 0)
        bpe = (qcfg.migration_bytes_per_expert
               if rcfg.bytes_per_expert is None else rcfg.bytes_per_expert)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.array(a)).to(dev)
        cc = dict(self._ctrl_device(),
                  base_scores=put(bs[np.arange(K1) % n_slots]),
                  decide_mask=put(dmask),
                  mig_w=put(np.array([w for _, w, _ in cells])),
                  bytes_mat=put(ct["n_moved"] * bpe))
        n_rounds = (max(1, int(rcfg.controller_iterations))
                    if rcfg.mode == "backlog" else 1)
        meta = _CtrlMeta(
            n_iter=max(1, qcfg.iterations), n_bins=T, n_rows=self.n_rows,
            n_rows_sched=ct["n_rows_sched"], n_cand=C, n_slots=n_slots,
            n_bounds=ct["n_bounds"], n_rounds=n_rounds,
            adm_on=self.admission_on,
            mode_backlog=(rcfg.mode == "backlog"),
            hysteresis=float(rcfg.hysteresis),
            ref_q=(float(acfg.reference_quantile)
                   if self.admission_on else 0.0),
            decide_bins=ct["decide_bins"],
            n_mig_chunks=ct["n_mig_chunks"], mig_bounds=ct["mig_bounds"])

        # The probe depends on the admission (TTFT, TPOT) target alone,
        # so it runs at the deduplicated width F_u and is gathered back
        # to F: a grid with one admission target probes once.
        uniq, inv = np.unique(np.stack([tt, tp], axis=1), axis=0,
                              return_inverse=True)
        Fu = uniq.shape[0]
        cc["probe_gather"] = put(inv.astype(np.int64).reshape(F))
        targets = (None, None)
        if self.admission_on:
            cc["probe_ttft"] = put(uniq[:, 0].astype(np.float32))
            cc["probe_tpot"] = put(uniq[:, 1].astype(np.float32))
            targets = (put(tt.astype(np.float32)),
                       put(tp.astype(np.float32)))
        # The probe's chunk table: every cell offers the whole trace.
        pct = self.chunk_table(np.ones((Fu, R), dtype=bool))
        plane0 = np.bincount(pct["flat0"], weights=pct["work0"],
                             minlength=Fu * self.n_rows * T).reshape(
            Fu, self.n_rows, T).astype(np.float64, copy=False)
        if self._mig_rm is not None:
            plane0 += self._mig_rm[None]
        chunks = {k: put(pct[k])
                  for k in ("src", "offs", "work", "fprow", "row_ptr", "fpr")
                  if k in pct}
        work0, work0_sum = put(plane0.astype(np.float32)), \
            put(plane0.sum(axis=2))
        q = self._device_tables()
        if stage is not None:
            stage("probe_table")
        out = _ctrl_core(q, chunks, work0, work0_sum, *targets, cc, meta,
                         stage=stage)

        def host(tree):
            return {k: v.cpu().numpy() for k, v in tree.items()}
        sp_all = out["slot_plan"].cpu().numpy()
        telem, probe_o, sched_o = (host(out[k])
                                   for k in ("telem", "probe", "sched"))
        srows = ct["srows"]

        def expand_srows(a):
            full = np.zeros(a.shape[:-1] + (self.n_stations,), a.dtype)
            full[..., srows] = a
            return full

        names = list(self.batch.names)
        outcomes = []
        for f in range(F):
            schedule = PlanSchedule(plans=self.plans, slot_plan=sp_all[f],
                                    name=f"replan/{rcfg.mode}")
            decisions = [
                ReplanDecision(
                    boundary=k, slot=k % n_slots,
                    chosen=int(telem["chosen"][f, k]),
                    switched=bool(telem["switched"][f, k]),
                    scores=telem["scores"][f, k].copy(),
                    migration_bytes=float(telem["mig_bytes"][f, k]))
                for k in range(K1) if dmask[f, k]]
            # The decision-event channel: the decide walk's telemetry at
            # this cell's decide boundaries.
            dk = np.flatnonzero(dmask[f])
            trace = DecisionTrace(
                period_s=float(qcfg.slot_period_s),
                boundaries=dk.astype(np.int64),
                slots=(dk % n_slots).astype(np.int64),
                scores=telem["scores"][f, dk].astype(np.float64),
                chosen=telem["chosen"][f, dk].astype(np.int64),
                switched=telem["switched"][f, dk].astype(bool),
                migration_bytes=telem["mig_bytes"][f, dk]
                .astype(np.float64))
            report = ReplanReport(schedule=schedule, decisions=decisions,
                                  candidates=list(self.plans), trace=trace)
            probe_res = None
            if rcfg.mode == "backlog":
                po = {k2: v[f] for k2, v in probe_o.items()}
                po["work_sum"] = self._expand_rows(po["work_sum"])
                probe_res = self._finalize(np.ones(R, dtype=bool), po,
                                           self.admission_on)
            stitched = {
                k2: np.concatenate([probe_o[k2][f], sched_o[k2][f]],
                                   axis=0)
                for k2 in ("ttft", "e2e", "tok_total", "tok_over",
                           "shed", "retries")}
            stitched["work_sum"] = np.concatenate(
                [self._expand_rows(probe_o["work_sum"][f]),
                 expand_srows(sched_o["work_sum"][f])[None]], axis=0)
            plan_tok = sp_all[f][self.slots]
            billed = float(sum(
                mg.bytes_moved for _, mg in schedule.migrations_over(
                    T * qcfg.dt_s, qcfg.slot_period_s,
                    qcfg.migration_bytes_per_expert)))
            res = self._finalize(
                np.ones(R, dtype=bool), stitched, self.admission_on,
                names=names + [schedule.name],
                nan_tok=np.concatenate(
                    [self.nan_tok,
                     self.nan_tok[plan_tok, np.arange(M)][None]]),
                fail_ingress=np.concatenate(
                    [self.fail_ingress,
                     self.fail_ingress[plan_tok[:R], np.arange(R)][None]]),
                migration_bytes=np.append(self.migration_bytes, billed))
            outcomes.append(ReplanOutcome(report=report, result=res,
                                          probe=probe_res, sim=self))
        if stage is not None:
            stage("finalize")
        return outcomes

    def run_legacy(self, active: np.ndarray | None = None,
                   zero_load: bool = False,
                   kv_slots: int | None = None) -> TrafficResult:
        """Host-path reference fixed point: schedule, binning and gather
        in NumPy, the backlog scan (and under admission the controller,
        :func:`.admission.admission_queue_scan`) on the device in float32
        (the reference's ``run_legacy``).  Under batching the law runs on
        the host in float64, or under admission inside
        ``admission_queue_scan`` on float32 planes, as the reference's
        does (its jitted scan runs without x64)."""
        qcfg = self.qcfg
        acfg = qcfg.admission
        req = self.requests
        P, R = self.n_plans, self.n_requests
        M, L = self.n_tokens, self.n_layers
        if active is None:
            active = np.ones(R, dtype=bool)
        active = np.asarray(active, dtype=bool)

        adm_on = self.admission_on and not zero_load
        shed = np.zeros((P, R), dtype=bool)
        retries = np.zeros((P, R), dtype=np.int64)
        ingress_extra = self.ingress_extra
        start_pref = self.start_pref
        dev = self.device
        if adm_on:
            admit_floor = np.ones((P, self.n_gw_stations, self.n_bins))
            margin = acfg.target_margin
            pid = None
            if acfg.policy == "pid":
                gain = np.ones(P) if acfg.gain_scale is None \
                    else np.asarray(acfg.gain_scale, dtype=np.float64)
                pid = dict(kp=acfg.kp, ki=acfg.ki, kd=acfg.kd,
                           gain=torch.from_numpy(gain.astype(np.float32)))
            adm_args = [torch.from_numpy(a).to(dev) for a in (
                self._adm_ttft0.astype(np.float32),
                self._adm_tpot0.astype(np.float32),
                control_bin_flags(self.n_bins, qcfg.dt_s, acfg.interval_s),
                self._adm_gw_idx, self._adm_exp_idx,
                np.ones((P, self.n_gw_stations), dtype=np.float32))]

        gw_wait = np.zeros((P, M, L))
        ex_max = np.zeros((P, M, L))
        gw_over = np.zeros((P, M, L), dtype=bool)
        ex_over = np.zeros((P, M, L), dtype=bool)
        n_iter = 1 if zero_load else max(1, qcfg.iterations)
        for _ in range(n_iter):
            layer_arr, exp_arr, tok_total, seg_incl, c0 = \
                self._schedule(gw_wait, ex_max, start_pref)
            work = self._bin_work(layer_arr, exp_arr,
                                  active[None, :] & ~shed)
            if zero_load:
                break
            batch_kw = None
            scan_work = work
            if self.batching is not None:
                wdec, cnt = self._bin_work_planes(
                    layer_arr, exp_arr, active[None, :] & ~shed)
                if adm_on:
                    planes = dict(
                        work_dec=wdec, table=self._batch_table,
                        cnt_win=windowed_counts(cnt, self._batch_window))
                    batch_kw = {k: torch.from_numpy(v.astype(np.float32))
                                .to(dev) for k, v in planes.items()}
                    batch_kw["bcap"] = float(np.float32(self._batch_cap))
                    scan_work = work.astype(np.float32)
                else:
                    scan_work, _ = effective_work_np(
                        work, wdec, cnt, self._batch_table,
                        self._batch_cap, self._batch_window)
            work_t = torch.from_numpy(scan_work).to(dev)
            if adm_on:
                wait, dropped, admit = admission_queue_scan(
                    work_t, float(qcfg.buffer_s), qcfg.dt_s, *adm_args,
                    margin * acfg.ttft_target_s,
                    margin * acfg.tpot_target_s, acfg.increase,
                    acfg.decrease, acfg.admit_min, batching=batch_kw,
                    pid=pid)
                # Monotone outer iteration: the admit trace accumulates as
                # a running minimum, so the shed set only grows.
                admit_floor = np.minimum(admit_floor, admit.cpu().numpy())
                choice, shed = resolve_admission(
                    admit_floor, self._att_bin, self._att_station,
                    self._att_feasible, self._adm_u)
                retries = np.where(shed, 0, choice)
                ingress_extra = np.take_along_axis(
                    np.moveaxis(self._att_extra, 0, 1),     # (P, A, R)
                    retries[:, None, :], axis=1)[:, 0, :]   # (P, R)
                start_pref = req.arrival_s[None, :] + ingress_extra
            else:
                wait, dropped = _fleet_queue_scan(
                    work_t, float(qcfg.buffer_s), qcfg.dt_s)
            wait = wait.cpu().numpy()
            overload = dropped.cpu().numpy() > 0.0
            self.last_wait = wait
            gw_wait, ex_max, gw_over, ex_over = self._gather(
                wait, overload, layer_arr, exp_arr)
        layer_arr, exp_arr, tok_total, seg_incl, c0 = \
            self._schedule(gw_wait, ex_max, start_pref)

        last_tok = self.first_tok + req.decode_len - 1
        ttft = ingress_extra + tok_total[:, :R]                   # (P, R)
        out = dict(
            ttft=ttft, e2e=ttft + seg_incl[:, last_tok],
            tok_total=tok_total,
            tok_over=gw_over.any(axis=2) | ex_over.any(axis=2),
            shed=shed, retries=retries, work_sum=work.sum(axis=2))
        return self._finalize(active, out, adm_on, kv_slots)

    def _finalize(self, active: np.ndarray, out: dict, adm_on: bool,
                  kv_slots: int | None = None, *,
                  names: list | None = None,
                  nan_tok: np.ndarray | None = None,
                  fail_ingress: np.ndarray | None = None,
                  migration_bytes: np.ndarray | None = None
                  ) -> TrafficResult:
        """Host post-processing shared by every execution path: delivery
        failure aggregation (shed requests apart under admission), the
        static KV admission cap (off under admission), spans, utilization
        and the latency quantiles' NaN masking.  The plan axis comes from
        ``out`` (the joint control plane stitches the decided schedule's
        row onto the candidates'); the keywords give that row's per-plan
        tables, by default the simulator's own."""
        qcfg, req = self.qcfg, self.requests
        R = self.n_requests
        P = out["ttft"].shape[0]
        names = self.batch.names if names is None else names
        nan_tok = self.nan_tok if nan_tok is None else nan_tok
        fail_ingress = (self.fail_ingress if fail_ingress is None
                        else fail_ingress)
        migration_bytes = (self.migration_bytes if migration_bytes is None
                           else migration_bytes)
        kv = qcfg.kv_slots if kv_slots is None else kv_slots
        ttft, e2e, tok_total = out["ttft"], out["e2e"], out["tok_total"]
        shed, retries = out["shed"], out["retries"]

        fail_tok = nan_tok | out["tok_over"]
        failed = fail_tok[:, :R] \
            | _segment_any(fail_tok[:, R:], self.tok_req, R)      # (P, R)
        if adm_on:
            # Shed requests are accounted apart from involuntary drops;
            # admitted requests entered through a feasible attempt.
            failed = failed | shed
        else:
            failed = failed | fail_ingress

        # KV admission cap: reject arrivals that would exceed the
        # in-flight budget (in-flight counted over all offered requests).
        admitted = np.ones((P, R), dtype=bool)
        if kv > 0 and not adm_on:
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
                plan_name=names[p],
                active=active.copy(),
                served=served[p],
                ttft_s=np.where(served[p], ttft[p], np.nan),
                tpot_s=np.where(served[p], tpot, np.nan),
                e2e_s=np.where(served[p], e2e[p], np.nan),
                decode_len=req.decode_len,
                station_util=util[p],
                span_s=span,
                token_total_s=tok_total[p],
                shed=(shed[p] & active) if adm_on else None,
                retries=np.where(served[p], retries[p], 0)
                if adm_on else None,
                migration_bytes=float(migration_bytes[p]),
            ))
        return TrafficResult(plans=plans_out, requests=req,
                             slots=self.slots, n_bins=self.n_bins,
                             dt_s=qcfg.dt_s)


def simulate_traffic(plans: list, topo: TopologySample,
                     activation: ActivationModel, workload: MoEWorkload,
                     compute: ComputeConfig, requests: RequestBatch,
                     rng: np.random.Generator,
                     qcfg: QueueConfig = QueueConfig(),
                     ground: GroundSegment | None = None, **kwargs
                     ) -> TrafficResult:
    """Build a :class:`FleetSim` and run it with every request active."""
    sim = FleetSim(plans, topo, activation, workload, compute, requests,
                   rng, qcfg=qcfg, ground=ground, **kwargs)
    return sim.run()
