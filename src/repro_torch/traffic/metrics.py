"""Serving metrics, SLOs and saturation sweeps.

TTFT  — time-to-first-token: uplink + ingress hop + prefill (+ queueing,
        + retry backoff/forwarding for admission-retried requests).
TPOT  — time-per-output-token: mean decode-step latency after the first
        token.
E2E   — request completion time.
Goodput — decode tokens/s delivered by served (non-dropped, admitted)
        requests over the arrival span.
Shed  — requests rejected by the adaptive admission controller after
        exhausting their gateway retries; accounted separately from
        involuntary drops (a shed request gets an immediate fast-fail
        response, a dropped one times out), so ``drop_rate`` only counts
        the involuntary kind and ``goodput`` only counts served decode
        tokens — the "goodput under control" the admission benchmarks
        trade against the latency target.

``saturation_sweep`` finds the highest arrival rate at which a plan
still meets an :class:`SLO`, by Poisson-thinning one request trace with
*nested* masks (the same uniform draw decides a request's membership at
every rate, so sweeps are monotone by construction and share the single
:class:`~repro_torch.traffic.queueing.FleetSim` precompute).

A copy of ``repro.traffic.metrics`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

if typing.TYPE_CHECKING:                              # pragma: no cover
    from .queueing import FleetSim
from .requests import RequestBatch


@dataclasses.dataclass(frozen=True)
class SLO:
    """A serving service-level objective, checked at a latency quantile."""

    ttft_s: float = 60.0
    tpot_s: float = 3.0
    quantile: float = 0.99
    max_drop: float = 0.01

    def describe(self) -> str:
        """One-line human-readable rendering of the objective."""
        q = int(round(self.quantile * 100))
        return (f"p{q} TTFT<={self.ttft_s:g}s, p{q} TPOT<={self.tpot_s:g}s, "
                f"drop<={self.max_drop:.0%}")


@dataclasses.dataclass
class PlanTraffic:
    """Per-plan request-level outcome of one traffic simulation.

    Attributes:
        plan_name: Name of the placement plan this row belongs to.
        active: (R,) request participated in this run.
        served: (R,) active, admitted, and fully delivered.
        ttft_s: (R,) time-to-first-token, NaN unless served.
        tpot_s: (R,) time-per-output-token, NaN unless served.
        e2e_s: (R,) completion time, NaN unless served.
        decode_len: (R,) decode tokens per request.
        station_util: (S,) offered utilization per station.
        span_s: Arrival span of the active requests, seconds.
        token_total_s: (M,) per-token latency incl. queueing.
        shed: (R,) rejected by the admission controller after all
            gateway retries (None when no controller ran).
        retries: (R,) gateway-retry attempts used by served requests
            (0 = admitted at the original gateway; None when no
            controller ran).
        migration_bytes: Weight bytes the plan row's
            :class:`~repro_torch.core.schedule.PlanSchedule` migrated at slot
            boundaries within the horizon (0.0 for a static plan).
    """

    plan_name: str
    active: np.ndarray
    served: np.ndarray
    ttft_s: np.ndarray
    tpot_s: np.ndarray
    e2e_s: np.ndarray
    decode_len: np.ndarray
    station_util: np.ndarray
    span_s: float
    token_total_s: np.ndarray
    shed: np.ndarray | None = None
    retries: np.ndarray | None = None
    migration_bytes: float = 0.0

    @property
    def n_active(self) -> int:
        """Number of requests offered in this run."""
        return int(self.active.sum())

    @property
    def shed_rate(self) -> float:
        """Fraction of offered requests the admission controller shed
        (0.0 when no controller ran)."""
        n = self.n_active
        if self.shed is None or not n:
            return 0.0
        return float(self.shed.sum() / n)

    @property
    def drop_rate(self) -> float:
        """Fraction of offered requests that failed *involuntarily*
        (undeliverable tokens, backpressure overflow, static-cap
        rejections) — controller sheds are excluded."""
        n = self.n_active
        if not n:
            return 0.0
        return float(1.0 - self.served.sum() / n) - self.shed_rate

    @property
    def retry_rate(self) -> float:
        """Fraction of served requests that needed >= 1 gateway retry."""
        if self.retries is None or not self.served.any():
            return 0.0
        return float((self.retries[self.served] > 0).mean())

    @property
    def goodput_tok_s(self) -> float:
        """Decode tokens/s delivered by served requests over the span —
        the goodput-under-control figure the admission frontier plots
        (exactly 0.0 when the plan row is degenerate: nothing offered,
        nothing served, or a non-positive span — every execution path
        derives the figure from this one guarded property)."""
        if self.span_s <= 0.0 or not self.n_active:
            return 0.0
        return float(self.decode_len[self.served].sum() / self.span_s)

    @property
    def offered_rps(self) -> float:
        """Offered request rate (active requests over the arrival span;
        exactly 0.0 when nothing was offered or the span is
        degenerate)."""
        if self.span_s <= 0.0 or not self.n_active:
            return 0.0
        return self.n_active / self.span_s

    def with_added_latency(self, extra_s: np.ndarray) -> "PlanTraffic":
        """Copy with per-request latency added to TTFT and E2E.

        The federation scheduler bills inter-constellation forwarding
        into the latencies of overflow-routed requests this way (the
        admission controller's gateway-retry pattern lifted one level up): the same shift
        lands on TTFT and E2E, so TPOT — their difference over the
        decode length — is unchanged, and NaN (unserved) entries stay
        NaN.

        Args:
            extra_s: (R,) seconds to add per request (0 for requests
                that were never forwarded).

        Returns:
            A new :class:`PlanTraffic`; ``self`` is untouched.
        """
        extra = np.asarray(extra_s, dtype=np.float64)
        return dataclasses.replace(
            self, ttft_s=self.ttft_s + extra, e2e_s=self.e2e_s + extra)

    def quantile(self, which: str, q: float) -> float:
        """Latency quantile over served requests.

        Args:
            which: ``"ttft"`` | ``"tpot"`` | ``"e2e"``.
            q: Quantile in [0, 1].

        Returns:
            The quantile in seconds (NaN when nothing was served, or
            when every served latency is non-finite — e.g. the TPOT of
            zero-decode requests).
        """
        arr = {"ttft": self.ttft_s, "tpot": self.tpot_s,
               "e2e": self.e2e_s}[which][self.served]
        arr = arr[np.isfinite(arr)]
        return float(np.quantile(arr, q)) if len(arr) else float("nan")

    def meets(self, slo: SLO) -> bool:
        """True iff this run satisfies ``slo`` (quantiles over served
        requests; ``max_drop`` checked against involuntary drops)."""
        if self.drop_rate > slo.max_drop:
            return False
        if not self.served.any():
            return False
        return (self.quantile("ttft", slo.quantile) <= slo.ttft_s
                and self.quantile("tpot", slo.quantile) <= slo.tpot_s)

    def row(self, slo: SLO | None = None) -> dict:
        """Flat summary dict (one table/JSON row)."""
        out = {
            "plan": self.plan_name,
            "offered_rps": round(self.offered_rps, 4),
            "goodput_tok_s": round(self.goodput_tok_s, 3),
            "drop_rate": round(self.drop_rate, 4),
            "shed_rate": round(self.shed_rate, 4),
            "retry_rate": round(self.retry_rate, 4),
            "ttft_p50_s": round(self.quantile("ttft", 0.5), 3),
            "ttft_p99_s": round(self.quantile("ttft", 0.99), 3),
            "tpot_p50_s": round(self.quantile("tpot", 0.5), 3),
            "tpot_p99_s": round(self.quantile("tpot", 0.99), 3),
            "e2e_p99_s": round(self.quantile("e2e", 0.99), 3),
            "max_util": round(float(self.station_util.max())
                              if self.station_util.size else 0.0, 3),
            "migration_mb": round(self.migration_bytes / 1e6, 3),
        }
        if slo is not None:
            out["slo_met"] = bool(self.meets(slo))
        return out


@dataclasses.dataclass
class TrafficResult:
    """Outcome of one fleet simulation: one :class:`PlanTraffic` per plan
    of the sweep, plus the shared token bookkeeping the tests pin down."""

    plans: list[PlanTraffic]
    requests: RequestBatch
    slots: np.ndarray          # (M,) topology slot per engine token
    n_bins: int
    dt_s: float

    def __getitem__(self, i: int) -> PlanTraffic:
        """The i-th plan's :class:`PlanTraffic` (sweep order)."""
        return self.plans[i]

    def by_name(self, name: str) -> PlanTraffic:
        """Look up a plan's outcome by its plan name (KeyError if absent)."""
        for p in self.plans:
            if p.plan_name == name:
                return p
        raise KeyError(name)

    def table(self, slo: SLO | None = None, scenario: str = "") -> list[dict]:
        """One flat summary row per plan (optionally SLO-checked and
        tagged with a scenario name)."""
        rows = []
        for p in self.plans:
            row = p.row(slo)
            if scenario:
                row = {"scenario": scenario, **row}
            rows.append(row)
        return rows


def format_table(rows: list[dict], prefix: str = "") -> str:
    """Fixed-width text table from a list of flat dicts."""
    if not rows:
        return prefix + "(no rows)"
    cols = list(rows[0].keys())
    widths = {c: max(len(str(c)), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    lines = [" ".join(str(c).ljust(widths[c]) for c in cols)]
    for r in rows:
        lines.append(" ".join(str(r.get(c, "")).ljust(widths[c])
                              for c in cols))
    return "\n".join(prefix + ln for ln in lines)


# --------------------------------------------------------------------- #
# Saturation sweep
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class SaturationResult:
    """Max sustained arrival rate per plan under an SLO."""

    slo: SLO
    tested_rps: np.ndarray                 # (n_rates,) offered rates
    met: dict[str, np.ndarray]             # plan -> (n_rates,) bool
    sustained_rps: dict[str, float]        # plan -> max offered rate met
    results: list                          # per-rate TrafficResult

    def capacity_ratio(self, a: str, b: str) -> float:
        """Sustained-capacity ratio a/b (inf if b sustains nothing)."""
        num, den = self.sustained_rps[a], self.sustained_rps[b]
        return float(num / den) if den > 0 else float("inf")


def saturation_sweep(
    sim: "FleetSim",
    slo: SLO,
    rng: np.random.Generator,
    fractions: np.ndarray | None = None,
) -> SaturationResult:
    """Thin the simulator's request trace to each fraction and find the
    highest offered rate per plan that still meets the SLO.

    The trace held by ``sim`` is treated as the 100% (envelope) rate; a
    single uniform draw per request makes the thinned sets nested, so a
    plan's pass/fail curve is evaluated on monotone workloads and
    "sustained" is the largest tested rate whose run met the SLO.

    The whole sweep executes as **one compile + one device launch**: the
    nested masks ride the vmapped fraction axis of
    :meth:`~repro_torch.traffic.queueing.FleetSim.run_many`, so adding rates
    costs batched device work, not extra fixed-point round-trips.
    """
    if fractions is None:
        fractions = np.array([0.125, 0.25, 0.5, 0.75, 1.0])
    fractions = np.sort(np.asarray(fractions, dtype=np.float64))
    u = rng.random(sim.requests.n_requests)
    masks = u[None, :] < fractions[:, None]

    results, rates = [], []
    met: dict[str, list[bool]] = {}
    for res in sim.run_many(masks):
        results.append(res)
        # No local re-derivation: the guarded ``offered_rps`` property
        # is the single source for the rate figure, so a degenerate
        # zero-offered row reads identically here and in a per-target
        # ``run`` (pinned in tests/test_metrics.py).
        rates.append(res.plans[0].offered_rps)
        for p in res.plans:
            met.setdefault(p.plan_name, []).append(p.meets(slo))

    rates_arr = np.asarray(rates)
    met_arr = {k: np.asarray(v) for k, v in met.items()}
    sustained = {}
    for name, ok in met_arr.items():
        sustained[name] = float(rates_arr[ok].max()) if ok.any() else 0.0
    return SaturationResult(slo=slo, tested_rps=rates_arr, met=met_arr,
                            sustained_rps=sustained, results=results)
