"""Planet-scale federation: K constellations, one fixed point a round.

Counterpart of ``repro.traffic.federation``.  A :class:`FederationSim`
wraps K independently-planned constellations — each an ordinary
:class:`~repro_torch.traffic.queueing.FleetSim` world with its own
topology, plans/schedules and admission config — behind one shared
:class:`~repro_torch.traffic.ground.GroundSegment`, and serves the whole
federation through the *existing* fused fleet fixed point
(:func:`~repro_torch.traffic.queueing._fleet_fixed_point`) on the
members' device:

* **One fixed point a round.**  Member tables are padded to common
  shapes (plans edge-repeated to ``P_max``, queue rows zero-extended to
  ``rows_max``; the time-bin count ``T`` must already agree — see
  :func:`build_federation`) and stacked along the F-leading sweep axis of
  the fixed point.  A federation of K members under an S-point nested
  rate sweep runs as ``F = S * K`` lanes (lane ``f = s * K + k`` carries
  member ``k`` under sweep entry ``s``) of one call, and every overflow
  round is one more call over the same shapes.  With overflow routing
  off, each lane's arithmetic is element-for-element the member's own
  ``run``, so per-constellation results are **bitwise identical** to
  running each ``FleetSim`` alone — the parity anchor.

* **Overflow scheduling.**  Requests shed by one member's admission
  controller retry at the next-best constellation: the per-request
  preference order generalizes the per-constellation ranked-visibility
  gateway table across members
  (:func:`~repro_torch.traffic.ground.rank_constellations` over each
  member's ingress cost), and each forward is billed into TTFT/E2E like
  the gateway retries (terrestrial forward delay + the rejecting
  controller's retry backoff).  The host-side loop is monotone the way
  the running-minimum admit trace is: a rejection is permanent (the
  request is never re-offered to that member), so per-member rejection
  sets only grow, hop pointers only advance, and the loop converges in
  at most ``K`` rounds.

Padding is exact, not approximate: padded plan lanes repeat the last
real plan (they compute independently and are sliced off the outputs),
padded rows receive zero work and are never gathered, and shed requests
deposit nothing — so removing a rejected request from a member's mask
leaves that member's remaining outcomes bit-for-bit unchanged while the
receiving member only *gains* load (its shed set can only grow).

The lanes read the kernels' existing layouts: the chunk table is the
lanes' row-sorted tables one after another (``fprow`` nondecreasing, so
one ``row_ptr`` over the ``F * rows_max`` plane describes it for
``deposit``), padded rows are zero-work rows for ``backlog_scan``, and the
controller's station maps are per (slot, lane) tables, the per-entry form
of ``admission_window`` (see :meth:`FederationSim._stacked_consts`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batching import effective_work_np
from .ground import GroundSegment, rank_constellations
from .metrics import PlanTraffic
from .queueing import _CHUNK_BLOCK, FleetSim, _fleet_fixed_point


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """Federation-scheduler knobs.

    Attributes:
        overflow: Route admission-shed requests to the next-best
            member constellation (requires every member to run the
            adaptive admission controller).  ``False`` serves each
            request only at its home constellation — the bitwise
            parity anchor against standalone ``FleetSim`` runs.
        forward_delay_s: Terrestrial latency billed per
            inter-constellation forward (on top of the rejecting
            controller's ``retry_backoff_s``).  ``None`` derives the
            mean off-diagonal ground delay of the shared ground
            segment when one is given, else 0.15 s.
        max_hops: Forward budget per request (default ``K - 1`` — at
            most one visit per member).
        max_rounds: Relaunch budget for the overflow fixed point
            (default ``K``; the monotone rejection sets converge in at
            most that many rounds when ``max_hops`` is ``K - 1``).
        serve_plan: Plan row of each member whose shed mask drives the
            routing decisions (results are still reported for every
            plan).
    """

    overflow: bool = True
    forward_delay_s: float | None = None
    max_hops: int | None = None
    max_rounds: int | None = None
    serve_plan: int = 0


@dataclasses.dataclass
class FederationResult:
    """Outcome of one federation run (one nested-sweep entry).

    Attributes:
        members: One :class:`~repro_torch.traffic.metrics.TrafficResult`
            per member constellation, computed on its final offered mask
            with forwarding latency billed into TTFT/E2E.
        federated: Pooled :class:`~repro_torch.traffic.metrics.PlanTraffic`
            over the members' ``serve_plan`` rows — the federation's
            own goodput/latency row.  Its ``retries`` column records
            inter-constellation hops; its ``shed`` column marks
            requests rejected by every member they could reach.
        assigned: (R,) final member index per request (-1 when the
            request ended up offered nowhere).
        hops: (R,) inter-constellation forwards each request took.
        n_rounds: Overflow fixed-point rounds executed (1 = no
            request moved).
        offered: (K, R) final per-member offered masks.
    """

    members: list
    federated: PlanTraffic
    assigned: np.ndarray
    hops: np.ndarray
    n_rounds: int
    offered: np.ndarray


def _edge_pad(a: np.ndarray, n: int, axis: int) -> np.ndarray:
    """Pad ``a`` to length ``n`` along ``axis`` by repeating its last
    entry (the exact-padding policy for the plan axis: a padded plan
    lane recomputes the last real plan and is sliced off on output)."""
    cur = a.shape[axis]
    if cur == n:
        return a
    idx = np.concatenate([np.arange(cur),
                          np.full(n - cur, cur - 1, dtype=np.int64)])
    return np.take(a, idx, axis=axis)


def _zero_pad(a: np.ndarray, n: int, axis: int) -> np.ndarray:
    """Pad ``a`` to length ``n`` along ``axis`` with zeros (the queue
    -row policy: padded rows receive no deposits and are never
    gathered)."""
    cur = a.shape[axis]
    if cur == n:
        return a
    shape = list(a.shape)
    shape[axis] = n - cur
    return np.concatenate([a, np.zeros(shape, dtype=a.dtype)], axis=axis)


class FederationSim:
    """K constellations behind one ground segment, one fixed point a round.

    Args:
        sims: Member :class:`~repro_torch.traffic.queueing.FleetSim`
            worlds on one device.  They must share the request trace,
            the time-bin grid (``n_bins`` — build via
            :func:`build_federation` to equalize it), the queueing
            constants and — when admission is on — the controller law
            constants; topology, plans, schedules, ground visibility and
            admission *targets* are free per member.
        cfg: :class:`FederationConfig` (default: overflow on).
        home: Optional (R,) member index per request overriding the
            cost-based home assignment (benches use this to
            concentrate a hotspot on one member; -1 = use the cost
            ranking).
        ground: Optional shared ground segment — only used to derive
            ``forward_delay_s`` when the config leaves it ``None``.
    """

    def __init__(self, sims: list, cfg: FederationConfig | None = None,
                 *, home: np.ndarray | None = None,
                 ground: GroundSegment | None = None):
        if not sims:
            raise ValueError("a federation needs at least one member")
        self.sims = list(sims)
        self.cfg = cfg or FederationConfig()
        self._validate()
        K = len(self.sims)
        s0 = self.sims[0]
        self.device = s0.device
        self.n_members, self.n_requests = K, s0.n_requests
        self.n_bins = s0.n_bins
        self.requests = s0.requests
        self.admission_on = s0.admission_on
        self.serve_plan = self.cfg.serve_plan
        if not 0 <= self.serve_plan < min(s.n_plans for s in self.sims):
            raise ValueError("serve_plan out of range for some member")
        self._p_max = max(s.n_plans for s in self.sims)
        self._sr_max = max(s.n_rows for s in self.sims)
        # Member chunk gather indices remapped for the padded plan
        # block: the flat [layer | expert] pair per lane is laid out at
        # P_max plans, so expert-block sources shift up by the pad.
        self._fed_src = []
        for s in self.sims:
            gw_span = s.n_plans * s.n_tokens * s.n_layers
            shift = (self._p_max - s.n_plans) * s.n_tokens * s.n_layers
            self._fed_src.append(np.where(s._f_src < gw_span, s._f_src,
                                          s._f_src + shift))
        # Cross-constellation preference ranking: each member's ingress
        # cost for each request at the serve plan (+inf = its ground
        # segment cannot ingest the request), ranked best-first with
        # index tie-breaks — ground.ingress_ranked generalized across
        # members.
        costs = np.stack([
            np.where(s.fail_ingress[self.serve_plan], np.inf,
                     s.ingress_extra[self.serve_plan])
            for s in self.sims])                              # (K, R)
        self.ingress_cost = costs
        self.ranking = rank_constellations(costs)             # (R, K)
        self.feasible = np.isfinite(costs)                    # (K, R)
        best = self.ranking[:, 0]
        home_cost = np.where(self.feasible.any(axis=0), best, -1)
        if home is not None:
            home = np.asarray(home, dtype=np.int64)
            if home.shape != (self.n_requests,):
                raise ValueError(f"home must be ({self.n_requests},)")
            if (home >= K).any():
                raise ValueError("home index out of range")
            # Explicit homes must be feasible there; fall back to the
            # cost ranking (or -1) where they are not.
            ok = (home >= 0) & self.feasible[np.clip(home, 0, K - 1),
                                            np.arange(self.n_requests)]
            home_cost = np.where(ok, home, home_cost)
        self.home = home_cost                                 # (R,)
        if self.cfg.forward_delay_s is not None:
            self.forward_delay_s = float(self.cfg.forward_delay_s)
        elif ground is not None and ground.n_stations > 1:
            gd = ground.ground_delay_s
            off = ~np.eye(ground.n_stations, dtype=bool)
            self.forward_delay_s = float(gd[off].mean())
        else:
            self.forward_delay_s = 0.15
        self.max_hops = (K - 1 if self.cfg.max_hops is None
                         else int(self.cfg.max_hops))
        self.max_rounds = (K if self.cfg.max_rounds is None
                           else int(self.cfg.max_rounds))
        self._dev_cache: dict = {}

    # ------------------------------------------------------------- #
    # Validation + padded device tables
    # ------------------------------------------------------------- #

    def _validate(self) -> None:
        s0 = self.sims[0]
        req0 = s0.requests
        for i, s in enumerate(self.sims[1:], start=1):
            r = s.requests
            if not (np.array_equal(req0.arrival_s, r.arrival_s)
                    and np.array_equal(req0.prompt_len, r.prompt_len)
                    and np.array_equal(req0.decode_len, r.decode_len)
                    and np.array_equal(req0.station, r.station)):
                raise ValueError(
                    f"member {i} serves a different request trace — a "
                    f"federation shares one global trace")
            if s.device != s0.device:
                raise ValueError(
                    f"member {i} runs on {s.device}, member 0 on "
                    f"{s0.device}: a federation's lanes share one device")
            if s.n_bins != s0.n_bins:
                raise ValueError(
                    f"member {i} has {s.n_bins} time bins vs "
                    f"{s0.n_bins}: the fixed point's bin clipping is "
                    f"one T for every lane, so members must share n_bins — "
                    f"rebuild the shorter ones with min_bins="
                    f"{max(s.n_bins, s0.n_bins)} (build_federation "
                    f"does this)")
            q0, q = s0.qcfg, s.qcfg
            if (q0.dt_s, q0.buffer_s, q0.iterations) != \
                    (q.dt_s, q.buffer_s, q.iterations):
                raise ValueError(
                    f"member {i} queueing constants differ "
                    f"(dt_s/buffer_s/iterations are shared by the lanes)")
            if s.admission_on != s0.admission_on:
                raise ValueError(
                    "members must all run admission, or none")
            if s.admission_on:
                a0, a = q0.admission, q.admission
                same = (a0.policy == a.policy
                        and a0.increase == a.increase
                        and a0.decrease == a.decrease
                        and a0.admit_min == a.admit_min
                        and a0.interval_s == a.interval_s
                        and a0.max_retries == a.max_retries)
                if a0.policy == "pid":
                    same = same and (a0.kp, a0.ki, a0.kd) == \
                        (a.kp, a.ki, a.kd) \
                        and a0.gain_scale is None \
                        and a.gain_scale is None
                if not same:
                    raise ValueError(
                        f"member {i} admission law differs (the AIMD/"
                        f"PID constants are shared by the lanes; "
                        f"targets may differ, the law may not)")
            if not np.array_equal(s0.gw_service, s.gw_service):
                raise ValueError(
                    f"member {i} gateway service times differ — "
                    f"federation lanes share the per-token service "
                    f"array (use one workload/service model)")
            if (s.n_tokens, s.n_layers) != (s0.n_tokens, s0.n_layers):
                raise ValueError(
                    f"member {i} token/layer grid differs")
            if s._ex_rowc.shape[-1] != s0._ex_rowc.shape[-1]:
                raise ValueError(
                    f"member {i} expert gather depth differs")
            if s.admission_on and s._adm_exp_rowc_slot.shape[-1] \
                    != s0._adm_exp_rowc_slot.shape[-1]:
                raise ValueError(
                    f"member {i} admission station-map width differs")
            if s.admission_on and \
                    s._adm_ttft0.shape[1] != s0._adm_ttft0.shape[1]:
                raise ValueError(
                    f"member {i} gateway count differs — members share "
                    f"one ground segment (G is shared by the lanes)")
            if s.probes is not None or s0.probes is not None:
                raise ValueError(
                    "probes are not supported on federation launches")
            b0, b = s0.batching, s.batching
            if (b0 is None) != (b is None):
                raise ValueError(
                    "members must all batch, or none")
            if b0 is not None and not (
                    np.array_equal(s0._batch_table, s._batch_table)
                    and s0._batch_cap == s._batch_cap
                    and s0._batch_window == s._batch_window):
                raise ValueError(
                    f"member {i} batching table differs (shared const)")
        if self.cfg.overflow and not s0.admission_on:
            raise ValueError(
                "overflow routing re-routes admission-shed requests — "
                "it needs every member to run the adaptive admission "
                "controller (or pass FederationConfig(overflow=False))")

    def _stacked_consts(self) -> dict:
        """K-leading numpy stack of the members' fixed-point tables,
        padded to (P_max, rows_max).

        The controller's station maps: each member keeps them per
        topology slot with a (T,) slot of each bin, and the members'
        slot maps may differ (their constellations need not share a slot
        period).  The federation's map is over the distinct tuples of the
        members' slots that the bins take, ``slot_of_bin`` (T,) its index
        per bin, and the tables (NB, K, P, L) and (NB, K, P, L * I) hold
        each member's rows at its own slot of the tuple — no per-bin
        copy."""
        P, SR = self._p_max, self._sr_max
        sims = self.sims

        def plans(attr, axis=0):
            return np.stack([_edge_pad(getattr(s, attr), P, axis)
                             for s in sims])

        base = dict(
            eff_layer=plans("eff_layer"),            # (K, P, M, L)
            tok_base=plans("tok_base"),              # (K, P, M)
            ingress_extra0=plans("ingress_extra"),   # (K, P, R)
            gw_rows=plans("_gw_rowc"),               # (K, P, M, L)
            ex_rows=plans("_ex_rowc"),               # (K, P, M, L, I)
            gw_b0=plans("_gw_b0"), gw_fin0=plans("_gw_fin0"),
            ex_b0=plans("_ex_b0"), ex_fin0=plans("_ex_fin0"),
        )
        if any(s._mig_rm is not None for s in sims):
            base["mig_dense_f"] = np.stack([
                _zero_pad(s._mig_rm, SR, 0) if s._mig_rm is not None
                else np.zeros((SR, self.n_bins))
                for s in sims])                      # (K, rows, T)
        if self.admission_on:
            f32 = np.float32
            slots = np.stack([s._adm_slot_of_bin for s in sims])  # (K, T)
            tuples, bin_tuple = np.unique(slots, axis=1, return_inverse=True)
            base.update(
                ttft0=np.stack([_edge_pad(s._adm_ttft0.astype(f32), P, 0)
                                for s in sims]),     # (K, P, G)
                tpot0=np.stack([_edge_pad(s._adm_tpot0.astype(f32), P, 0)
                                for s in sims]),     # (K, P)
                slot_of_bin=bin_tuple.reshape(-1),   # (T,)
                gw_rows_slot=np.stack(
                    [_edge_pad(s._adm_gw_rowc_slot, P, 1)[tuples[k]]
                     for k, s in enumerate(sims)], axis=1),  # (NB, K, P, L)
                exp_rows_slot=np.stack(
                    [_edge_pad(s._adm_exp_rowc_slot, P, 1)[tuples[k]]
                     for k, s in enumerate(sims)], axis=1),  # (NB, K, P, LI)
                # Per-member attempt tables (the (F, A, R) branch of
                # queueing._resolve_attempts): retry gateways and bins
                # follow each member's own ground visibility.
                att_bin=np.stack([s._att_bin for s in sims]),
                att_station=np.stack([s._att_station for s in sims]),
                att_feasible=np.stack([
                    _edge_pad(np.moveaxis(s._att_feasible, 1, 0), P, 0)
                    for s in sims]),                 # (K, P, A, R)
                att_extra=np.stack([
                    _edge_pad(np.moveaxis(s._att_extra, 0, 1), P, 0)
                    for s in sims]),                 # (K, P, A, R)
                adm_u=np.stack([s._adm_u for s in sims]),  # (K, A, R)
            )
        return base

    def _device_consts(self, n_sweep: int) -> dict:
        """The fixed point's tables for ``F = n_sweep * K`` lanes on the
        members' device (lane ``f = s * K + k`` carries member ``k``): the
        K-leading stack tiled along the sweep, the station maps along
        their lane axis (the kernels take a map per entry or one shared
        by all, so the K maps repeat once per sweep entry), plus the
        shared request/clock tables and controller flags of member 0."""
        if n_sweep in self._dev_cache:
            return self._dev_cache[n_sweep]
        s0 = self.sims[0]
        dev = self.device
        sd = s0._device_tables()
        idx = torch.int32 if dev.type == "cuda" else torch.int64
        dtypes = dict(eff_layer=torch.float64, tok_base=torch.float64,
                      ingress_extra0=torch.float64, gw_rows=torch.int64,
                      ex_rows=torch.int64, gw_b0=torch.int64,
                      ex_b0=torch.int64, mig_dense_f=torch.float64,
                      slot_of_bin=idx, gw_rows_slot=idx, exp_rows_slot=idx,
                      att_bin=torch.int64, att_station=torch.int64,
                      att_extra=torch.float64, adm_u=torch.float64)
        d = {}
        for key, a in self._stacked_consts().items():
            if key in ("gw_rows_slot", "exp_rows_slot"):
                a = np.tile(a, (1, n_sweep) + (1,) * (a.ndim - 2))
            elif key != "slot_of_bin":
                a = np.tile(a, (n_sweep,) + (1,) * (a.ndim - 1))
            d[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtypes.get(key))
        for key in ("dt", "cap", "cap32", "dt32", "gw_service", "arrival_s",
                    "first_tok", "tok_req", "last_tok"):
            d[key] = sd[key]
        if self.admission_on:
            for key in ("ctrl", "seg", "n_ctrl"):
                d[key] = sd[key]
            kw = dict(sd["adm_kw"])
            if kw["pid"] is not None:
                # Member gains are refused by _validate: unit gain.
                kw["pid"] = dict(kw["pid"], gain=torch.ones(
                    self._p_max, dtype=torch.float32, device=dev))
            d["adm_kw"] = kw
        self._dev_cache[n_sweep] = d
        return d

    # ------------------------------------------------------------- #
    # Launch
    # ------------------------------------------------------------- #

    def _launch(self, offered: np.ndarray) -> dict:
        """One fixed point over ``F = n_sweep * K`` federation lanes.

        Mirrors :meth:`FleetSim._launch` per lane: lane ``f = s * K + k``
        deposits member ``k``'s active chunks under sweep entry ``s``'s
        mask, and the iteration-1 plane is one host bincount per lane.

        Args:
            offered: (n_sweep, K, R) bool per-member offered masks.

        Returns:
            The fixed point's outputs as host arrays, leading axis F.
        """
        return self._execute(self._prepare(offered))

    def _prepare(self, offered: np.ndarray) -> dict:
        """Host side of a launch: per-lane chunk compaction and the
        iteration-1 deposit planes.  Split from :meth:`_execute` so a
        benchmark can bill host prep and device time separately."""
        n_sweep, K, R = offered.shape
        F = n_sweep * K
        P, SR, T = self._p_max, self._sr_max, self.n_bins
        s0 = self.sims[0]
        M, L = s0.n_tokens, s0.n_layers
        pml2 = 2 * P * M * L
        batching = s0.batching is not None

        lane_cols: list[tuple[int, FleetSim, np.ndarray]] = []
        for s in range(n_sweep):
            for k, sim in enumerate(self.sims):
                cid = np.flatnonzero(offered[s, k][sim._f_req])
                lane_cols.append((s * K + k, sim, cid))
        n = sum(c.size for _, _, c in lane_cols)
        n_pad = max(-(-n // _CHUNK_BLOCK), 1) * _CHUNK_BLOCK

        src = np.zeros(n_pad, dtype=np.int64)
        offs = np.zeros(n_pad, dtype=np.int64)
        work = np.zeros(n_pad)
        fprow = np.zeros(n_pad, dtype=np.int64)
        fpr = np.zeros(n_pad, dtype=np.int64)
        wdec = np.zeros(n_pad) if batching else None
        cntw = np.zeros(n_pad) if batching else None
        plane0 = np.zeros((F, SR, T))
        plane0_dec = np.zeros((F, SR, T)) if batching else None
        cnt0 = np.zeros((F, SR, T)) if batching else None

        pos = 0
        for f, sim, cid in lane_cols:
            m = cid.size
            k = f % K
            sl = slice(pos, pos + m)
            src[sl] = f * pml2 + self._fed_src[k][cid]
            offs[sl] = sim._f_offs[cid]
            work[sl] = sim._f_work[cid]
            fprow[sl] = f * SR + sim._f_rowc[cid].astype(np.int64)
            fpr[sl] = f * (P * R) + sim._f_pr[cid]
            if batching:
                wdec[sl] = sim._f_wdec[cid]
                cntw[sl] = sim._f_cntw[cid]
            pos += m
            flat0 = sim._f_rowc[cid].astype(np.int64) * T \
                + sim._f_bins0[cid]
            w0 = sim._f_work[cid] * sim._f_fin0[cid]
            plane0[f] = np.bincount(
                flat0, weights=w0, minlength=SR * T
            ).reshape(SR, T).astype(np.float64)
            if sim._mig_rm is not None:
                plane0[f, :sim.n_rows] += sim._mig_rm
            if batching:
                plane0_dec[f] = np.bincount(
                    flat0, weights=sim._f_wdec[cid] * sim._f_fin0[cid],
                    minlength=SR * T).reshape(SR, T)
                cnt0[f] = np.bincount(
                    flat0, weights=sim._f_cntw[cid] * sim._f_fin0[cid],
                    minlength=SR * T).reshape(SR, T)
        # Each lane's chunks are row-sorted and the lanes follow one
        # another, so the table is grouped by fprow (deposit's row_ptr).
        row_ptr = np.searchsorted(fprow[:n], np.arange(F * SR + 1),
                                  side="left")

        work0_sum = plane0.sum(axis=2)
        batch_np: dict = {}
        if batching:
            plane0, _ = effective_work_np(
                plane0, plane0_dec, cnt0, s0._batch_table,
                s0._batch_cap, s0._batch_window)
            batch_np = dict(table=s0._batch_table, bcap=s0._batch_cap,
                            window=s0._batch_window)

        chunks = dict(src=src, offs=offs, work=work, fprow=fprow,
                      row_ptr=row_ptr)
        if self.admission_on:
            chunks["fpr"] = fpr
            tt = np.empty(F)
            tp = np.empty(F)
            for k, sim in enumerate(self.sims):
                acfg = sim.qcfg.admission
                m = acfg.target_margin
                tt[k::K] = m * acfg.ttft_target_s
                tp[k::K] = m * acfg.tpot_target_s
        else:
            tt = np.zeros(F)
            tp = np.zeros(F)
        if batching:
            chunks["wdec"], chunks["cntw"] = wdec, cntw

        return dict(chunks=chunks, plane0=plane0, work0_sum=work0_sum,
                    tt=tt, tp=tp, batch_np=batch_np, n_sweep=n_sweep,
                    T=T, SR=SR)

    def _execute(self, prep: dict) -> dict:
        """Device side of a launch: move the prepared chunk stream to
        the members' device and run the fixed point once."""
        s0 = self.sims[0]
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)
        targets = (None, None)
        if self.admission_on:
            targets = tuple(put(prep[k].astype(np.float32))
                            for k in ("tt", "tp"))
        batch = None
        if prep["batch_np"]:
            bn = prep["batch_np"]
            batch = dict(table=put(bn["table"]), bcap=bn["bcap"],
                         window=bn["window"])
        out = _fleet_fixed_point(
            self._device_consts(prep["n_sweep"]),
            {k: put(v) for k, v in prep["chunks"].items()},
            put(prep["plane0"].astype(np.float32)), put(prep["work0_sum"]),
            max(1, s0.qcfg.iterations), prep["T"], prep["SR"], False,
            *targets, batch=batch)
        return {k: v.cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------------------- #
    # Overflow fixed point + result assembly
    # ------------------------------------------------------------- #

    def run_many(self, masks: np.ndarray | None = None, *,
                 overflow: bool | None = None) -> list[FederationResult]:
        """Serve a nested sweep of global activity masks — the whole
        federation, every sweep entry, one fixed point a round.

        The first round covers every (sweep entry, member) lane; each
        overflow round removes newly-rejected requests from the
        rejecting member (permanently — the monotone invariant) and
        offers them to the next-best feasible member on their ranking,
        then runs the fixed point again over the same shapes.  The loop
        stops when no request moves or after ``max_rounds`` rounds.

        Args:
            masks: (n_sweep, R) bool global activity masks (None = one
                all-active entry).
            overflow: Override the config's overflow switch for this
                run.

        Returns:
            One :class:`FederationResult` per sweep entry.
        """
        R, K = self.n_requests, self.n_members
        if masks is None:
            masks = np.ones((1, R), dtype=bool)
        masks = np.asarray(masks, dtype=bool)
        if masks.ndim != 2 or masks.shape[1] != R:
            raise ValueError(f"masks must be (n_sweep, {R})")
        n_sweep = masks.shape[0]
        route = self.cfg.overflow if overflow is None else bool(overflow)
        if route and not self.admission_on:
            raise ValueError("overflow routing needs admission")

        # Home assignment: each active request starts at its preferred
        # feasible member; requests no member can ingest start nowhere.
        offered = np.zeros((n_sweep, K, R), dtype=bool)
        for k in range(K):
            offered[:, k] = masks & (self.home == k)[None, :]
        visited = offered.copy()                     # never re-offer
        assigned = np.where(masks, self.home[None, :], -1)  # (n_sweep, R)
        hops = np.zeros((n_sweep, R), dtype=np.int64)
        extra_s = np.zeros((n_sweep, R))

        sp = self.serve_plan
        n_rounds = 0
        while True:
            out = self._launch(offered)
            n_rounds += 1
            if not route or n_rounds >= self.max_rounds:
                break
            moved = False
            for s in range(n_sweep):
                for k in range(K):
                    f = s * K + k
                    rej = out["shed"][f, sp] & offered[s, k]
                    if not rej.any():
                        continue
                    # Permanent rejection at k: shed requests deposit
                    # nothing, so dropping them leaves k's remaining
                    # outcomes bit-identical.
                    offered[s, k][rej] = False
                    backoff = self.sims[k].qcfg.admission.retry_backoff_s
                    for r in np.flatnonzero(rej):
                        assigned[s, r] = -1
                        if hops[s, r] >= self.max_hops:
                            continue
                        for k2 in self.ranking[r]:
                            if visited[s, k2, r] or \
                                    not self.feasible[k2, r]:
                                continue
                            offered[s, k2, r] = True
                            visited[s, k2, r] = True
                            assigned[s, r] = k2
                            hops[s, r] += 1
                            extra_s[s, r] += \
                                self.forward_delay_s + backoff
                            moved = True
                            break
            if not moved:
                break

        return [self._assemble(masks[s], offered[s], out, s,
                               assigned[s], hops[s], extra_s[s],
                               n_rounds)
                for s in range(n_sweep)]

    def run(self, active: np.ndarray | None = None, *,
            overflow: bool | None = None) -> FederationResult:
        """Single-entry convenience wrapper around :meth:`run_many`."""
        if active is None:
            active = np.ones(self.n_requests, dtype=bool)
        return self.run_many(np.asarray(active, dtype=bool)[None, :],
                             overflow=overflow)[0]

    def _assemble(self, active, offered, out, s, assigned, hops,
                  extra_s, n_rounds) -> FederationResult:
        """Slice one sweep entry's lanes out of the fixed point's output,
        bill the forwarding latency, and pool the federation row."""
        K, sp = self.n_members, self.serve_plan
        members = []
        for k, sim in enumerate(self.sims):
            f = s * K + k
            o = dict(
                ttft=out["ttft"][f, :sim.n_plans],
                e2e=out["e2e"][f, :sim.n_plans],
                tok_total=out["tok_total"][f, :sim.n_plans],
                tok_over=out["tok_over"][f, :sim.n_plans],
                shed=out["shed"][f, :sim.n_plans],
                retries=out["retries"][f, :sim.n_plans],
                work_sum=sim._expand_rows(
                    out["work_sum"][f, :sim.n_rows]),
            )
            res = sim._finalize(offered[k], o, self.admission_on)
            if extra_s.any():
                res = dataclasses.replace(res, plans=[
                    p.with_added_latency(extra_s) for p in res.plans])
            members.append(res)

        # Pooled federation row over the serve-plan rows: the offered
        # masks are disjoint per round, so served sets never overlap.
        req = self.requests
        R = self.n_requests
        nan = np.full(R, np.nan)
        served = np.zeros(R, dtype=bool)
        ttft, tpot, e2e = nan.copy(), nan.copy(), nan.copy()
        retries = np.zeros(R, dtype=np.int64)
        shed_any = np.zeros(R, dtype=bool)
        mig = 0.0
        utils, toks = [], []
        for k, res in enumerate(members):
            row = res.plans[sp]
            sk = row.served
            served |= sk
            ttft[sk] = row.ttft_s[sk]
            tpot[sk] = row.tpot_s[sk]
            e2e[sk] = row.e2e_s[sk]
            retries[sk] = hops[sk]
            if row.shed is not None:
                # Final-round sheds only: earlier rejections already
                # left this member's offered mask.
                shed_any |= row.shed
            mig += row.migration_bytes
            utils.append(row.station_util)
            toks.append(row.token_total_s)
        span = max(float(req.arrival_s[active].max()
                         - req.arrival_s[active].min()),
                   self.sims[0].qcfg.dt_s) if active.any() \
            else self.sims[0].qcfg.dt_s
        federated = PlanTraffic(
            plan_name="federation",
            active=active.copy(),
            served=served,
            ttft_s=ttft, tpot_s=tpot, e2e_s=e2e,
            decode_len=req.decode_len,
            station_util=np.concatenate(utils),
            span_s=span,
            token_total_s=np.concatenate(toks),
            shed=(active & ((assigned < 0) | shed_any))
            if self.admission_on else None,
            retries=np.where(served, retries, 0)
            if self.admission_on else None,
            migration_bytes=mig,
        )
        return FederationResult(
            members=members, federated=federated, assigned=assigned,
            hops=hops, n_rounds=n_rounds, offered=offered.copy())


def build_federation(factories: list, cfg: FederationConfig | None = None,
                     **kwargs) -> FederationSim:
    """Construct member worlds on one shared time-bin grid.

    Each factory is a callable taking a ``min_bins`` keyword and
    returning a :class:`~repro_torch.traffic.queueing.FleetSim` (e.g. a
    ``functools.partial`` over ``FleetSim`` or
    :func:`repro_torch.traffic.scenarios.make_sim`).  Members are built
    once, then any member whose natural horizon came up short is
    rebuilt with ``min_bins`` pinned to the federation maximum — the
    fixed point clips bins at one T for every lane, so sharing the grid
    is what makes the padded stacking exact.

    Args:
        factories: K callables ``f(min_bins=...) -> FleetSim``.
        cfg: Passed through to :class:`FederationSim`.
        **kwargs: Passed through to :class:`FederationSim` (``home``,
            ``ground``).

    Returns:
        The federation over the (re)built members.
    """
    sims = [f(min_bins=0) for f in factories]
    t_max = max(s.n_bins for s in sims)
    sims = [s if s.n_bins == t_max else f(min_bins=t_max)
            for s, f in zip(sims, factories)]
    return FederationSim(sims, cfg, **kwargs)
