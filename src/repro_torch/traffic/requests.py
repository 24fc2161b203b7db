"""Request arrival processes for constellation-scale serving.

A :class:`RequestBatch` is the tensor form of a request trace: arrival
times, prompt/decode lengths and the originating ground station, all as
flat arrays so the queueing layer never loops over requests.

Arrival models
--------------
* homogeneous Poisson (exponential inter-arrival gaps),
* non-homogeneous Poisson via thinning — diurnal sinusoidal modulation
  (regional phase offsets: each ground station peaks at its local
  daytime) and transient regional hotspots (Gaussian bump on one
  station's rate),
* heavy-tail lengths: lognormal prompt lengths, geometric decode
  lengths, both clipped — the standard shape of LLM serving traces.

Planet-scale traces
-------------------
:func:`stream_arrivals` / :func:`stream_requests` run the same thinning
law one bounded time shard at a time, so a federation bench can push a
1e6+-user envelope through generation while only the kept survivors
ever materialize — peak RSS is O(shard), not O(envelope).

A copy of ``repro.traffic.requests`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np


@dataclasses.dataclass
class RequestBatch:
    """A trace of R requests, sorted by arrival time."""

    arrival_s: np.ndarray     # (R,) float, sorted ascending
    prompt_len: np.ndarray    # (R,) int >= 1
    decode_len: np.ndarray    # (R,) int >= 1
    station: np.ndarray       # (R,) int ground-station index

    def __post_init__(self):
        self.arrival_s = np.asarray(self.arrival_s, dtype=np.float64)
        self.prompt_len = np.asarray(self.prompt_len, dtype=np.int64)
        self.decode_len = np.asarray(self.decode_len, dtype=np.int64)
        self.station = np.asarray(self.station, dtype=np.int64)
        if not (np.diff(self.arrival_s) >= 0).all():
            raise ValueError("arrivals must be sorted by time")
        if (self.prompt_len < 1).any() or (self.decode_len < 1).any():
            raise ValueError("prompt/decode lengths must be >= 1")

    @property
    def n_requests(self) -> int:
        """Number of requests in the trace (R)."""
        return len(self.arrival_s)

    @property
    def total_decode_tokens(self) -> int:
        """Total decode tokens across the trace (N)."""
        return int(self.decode_len.sum())

    @property
    def horizon_s(self) -> float:
        """Last arrival time, seconds (0 for an empty trace)."""
        return float(self.arrival_s[-1]) if self.n_requests else 0.0

    def subset(self, mask: np.ndarray) -> "RequestBatch":
        """Thinned copy (Poisson thinning: a Bernoulli-kept subset of a
        Poisson trace is Poisson at the scaled rate)."""
        mask = np.asarray(mask, dtype=bool)
        return RequestBatch(
            arrival_s=self.arrival_s[mask], prompt_len=self.prompt_len[mask],
            decode_len=self.decode_len[mask], station=self.station[mask],
        )

    def request_of_token(self) -> np.ndarray:
        """(total_decode_tokens,) request index of every decode token.

        Memoized: the recorder/metrics paths call this once per plan
        row, and at 1e6-user scale the ``np.repeat`` is a measurable
        host cost.  The memo key covers the identity and the content
        signature of ``decode_len`` (length + token total), so
        replacing the array — the only supported mutation, e.g. via
        ``dataclasses.replace`` — invalidates it; the cached array is
        returned read-only so callers cannot corrupt the shared copy.
        """
        key = (id(self.decode_len), self.n_requests,
               self.total_decode_tokens)
        cached = getattr(self, "_token_req_memo", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        out = np.repeat(np.arange(self.n_requests), self.decode_len)
        out.setflags(write=False)
        object.__setattr__(self, "_token_req_memo", (key, out))
        return out


# --------------------------------------------------------------------- #
# Arrival-time processes
# --------------------------------------------------------------------- #


def poisson_arrivals(rate_rps: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson arrival times on [0, horizon)."""
    if rate_rps <= 0 or horizon_s <= 0:
        return np.empty(0, dtype=np.float64)
    # Draw ~N + 5 sigma gaps so a second draw is almost never needed.
    n_hint = int(rate_rps * horizon_s + 5.0 * np.sqrt(rate_rps * horizon_s) + 10)
    gaps = rng.exponential(1.0 / rate_rps, size=n_hint)
    t = np.cumsum(gaps)
    while t[-1] < horizon_s:                       # pragma: no cover - rare
        extra = rng.exponential(1.0 / rate_rps, size=n_hint)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return t[t < horizon_s]


def diurnal_rate(t: np.ndarray, base_rps: float, amplitude: float,
                 period_s: float, phase: float = 0.0) -> np.ndarray:
    """rate(t) = base * (1 + amplitude * sin(2 pi t / period + phase)),
    clipped at zero.  ``amplitude`` in [0, 1] keeps the rate nonnegative."""
    t = np.asarray(t, dtype=np.float64)
    r = base_rps * (1.0 + amplitude * np.sin(2.0 * np.pi * t / period_s + phase))
    return np.maximum(r, 0.0)


def hotspot_rate(t: np.ndarray, base_rps: float, boost: float,
                 center_s: float, width_s: float) -> np.ndarray:
    """rate(t) = base * (1 + boost * exp(-(t-center)^2 / 2 width^2)) — a
    transient regional surge (breaking-news / flash-crowd shape)."""
    t = np.asarray(t, dtype=np.float64)
    return base_rps * (1.0 + boost * np.exp(-0.5 * ((t - center_s) / width_s) ** 2))


def _thinning_probs(rates: np.ndarray, rate_max_rps: float,
                    clip: bool) -> np.ndarray:
    """Validated keep-probabilities ``rate(t)/rate_max``.

    Lewis-Shedler thinning is only exact when the envelope dominates
    the instantaneous rate; a ``rate_fn`` that exceeds ``rate_max_rps``
    used to silently saturate the keep-probability at 1 and bias the
    trace low.  Now it raises — or, with ``clip=True``, clips with a
    warning (the caller accepts the rate-capped trace knowingly).
    """
    rates = np.asarray(rates, dtype=np.float64)
    # Tiny tolerance: a rate_fn that *equals* the envelope at its peak
    # may overshoot by float rounding; that is not an envelope bug.
    tol = rate_max_rps * 1e-12
    if rates.size and float(rates.max()) > rate_max_rps + tol:
        if not clip:
            raise ValueError(
                f"thinning envelope violated: rate_fn peaks at "
                f"{float(rates.max()):g} rps > envelope "
                f"{rate_max_rps:g} rps — the thinned trace would be "
                f"biased low; raise rate_max_rps (or pass clip=True "
                f"to accept a rate-capped trace)")
        warnings.warn(
            f"thinning envelope violated (rate_fn peak "
            f"{float(rates.max()):g} > {rate_max_rps:g} rps); clipping "
            f"— the trace is rate-capped at the envelope",
            RuntimeWarning, stacklevel=3)
        rates = np.minimum(rates, rate_max_rps)
    return rates / rate_max_rps


def thinned_arrivals(rate_fn, rate_max_rps: float, horizon_s: float,
                     rng: np.random.Generator, *,
                     clip: bool = False) -> np.ndarray:
    """Non-homogeneous Poisson via Lewis-Shedler thinning: draw at the
    envelope rate, keep each arrival with prob rate(t)/rate_max.

    Raises ``ValueError`` if ``rate_fn`` ever exceeds the envelope
    (``clip=True`` clips with a warning instead)."""
    t = poisson_arrivals(rate_max_rps, horizon_s, rng)
    if len(t) == 0:
        return t
    keep = rng.random(len(t)) < _thinning_probs(rate_fn(t), rate_max_rps,
                                                clip)
    return t[keep]


def stream_arrivals(rate_fn, rate_max_rps: float, horizon_s: float,
                    rng: np.random.Generator, *,
                    shard_s: float = 600.0,
                    clip: bool = False) -> tuple[np.ndarray, int]:
    """Sharded Lewis-Shedler thinning for planet-scale envelopes.

    Distribution-identical to :func:`thinned_arrivals` (a thinned
    Poisson process is Poisson at the thinned rate regardless of how
    the envelope is generated), but the envelope process materializes
    one bounded time shard at a time: per shard the arrival count is
    Poisson(rate_max * shard) and the times are sorted uniforms (the
    conditional-uniform property), each kept with probability
    ``rate_fn(t)/rate_max`` before the next shard is drawn.  Peak
    memory is O(rate_max * shard_s + kept), not O(envelope) — the
    mechanism behind the million-user federation bench.

    Returns:
        ``(kept_times, n_generated)`` — kept arrival times (sorted,
        within ``[0, horizon_s)``) and the total number of *envelope*
        arrivals generated (the "users offered" count at planet scale).
    """
    if rate_max_rps <= 0 or horizon_s <= 0:
        return np.empty(0, dtype=np.float64), 0
    shard_s = min(float(shard_s), horizon_s)
    kept: list[np.ndarray] = []
    n_generated = 0
    a = 0.0
    while a < horizon_s:
        b = min(a + shard_s, horizon_s)
        n = int(rng.poisson(rate_max_rps * (b - a)))
        n_generated += n
        if n:
            t = np.sort(rng.uniform(a, b, size=n))
            keep = rng.random(n) < _thinning_probs(
                rate_fn(t), rate_max_rps, clip)
            if keep.any():
                kept.append(t[keep])
        a = b
    out = (np.concatenate(kept) if kept
           else np.empty(0, dtype=np.float64))
    return out, n_generated


# --------------------------------------------------------------------- #
# Length distributions
# --------------------------------------------------------------------- #


def sample_prompt_lens(n: int, rng: np.random.Generator,
                       median: int = 256, sigma: float = 1.0,
                       max_len: int = 4096) -> np.ndarray:
    """Lognormal prompt lengths (heavy right tail), clipped to [1, max]."""
    raw = rng.lognormal(mean=np.log(max(median, 1)), sigma=sigma, size=n)
    return np.clip(raw.astype(np.int64), 1, max_len)


def sample_decode_lens(n: int, rng: np.random.Generator,
                       mean: int = 64, max_len: int = 1024) -> np.ndarray:
    """Geometric decode lengths (memoryless stop decision per token),
    clipped to [1, max]."""
    raw = rng.geometric(1.0 / max(mean, 1), size=n)
    return np.clip(raw.astype(np.int64), 1, max_len)


# --------------------------------------------------------------------- #
# Full trace sampling
# --------------------------------------------------------------------- #


def sample_requests(
    rng: np.random.Generator,
    rate_rps: float,
    horizon_s: float,
    n_stations: int,
    station_weights: np.ndarray | None = None,
    arrival: str = "poisson",
    diurnal_amplitude: float = 0.6,
    diurnal_period_s: float = 86400.0,
    station_phases: np.ndarray | None = None,
    hotspot_station: int = 0,
    hotspot_boost: float = 4.0,
    hotspot_center_s: float | None = None,
    hotspot_width_s: float | None = None,
    prompt_median: int = 256,
    prompt_sigma: float = 1.0,
    prompt_max: int = 4096,
    decode_mean: int = 64,
    decode_max: int = 1024,
) -> RequestBatch:
    """Sample a full request trace.

    ``arrival`` is one of:

    * ``"poisson"`` — homogeneous, stations weighted by ``station_weights``;
    * ``"diurnal"`` — per-station sinusoidal modulation, each station
      phase-shifted (``station_phases``, default evenly spread over 2 pi
      like time zones around the globe);
    * ``"hotspot"`` — homogeneous everywhere plus a Gaussian surge on
      ``hotspot_station`` (``boost`` x base at the peak).
    """
    weights = (np.full(n_stations, 1.0 / n_stations)
               if station_weights is None
               else np.asarray(station_weights, dtype=np.float64))
    weights = weights / weights.sum()
    per_station_rate = rate_rps * weights

    times, stations = [], []
    if arrival == "poisson":
        for s in range(n_stations):
            t = poisson_arrivals(per_station_rate[s], horizon_s, rng)
            times.append(t)
            stations.append(np.full(len(t), s, dtype=np.int64))
    elif arrival == "diurnal":
        phases = (np.linspace(0.0, 2.0 * np.pi, n_stations, endpoint=False)
                  if station_phases is None else np.asarray(station_phases))
        for s in range(n_stations):
            env = per_station_rate[s] * (1.0 + diurnal_amplitude)
            t = thinned_arrivals(
                lambda tt, s=s: diurnal_rate(tt, per_station_rate[s],
                                             diurnal_amplitude,
                                             diurnal_period_s, phases[s]),
                env, horizon_s, rng)
            times.append(t)
            stations.append(np.full(len(t), s, dtype=np.int64))
    elif arrival == "hotspot":
        center = horizon_s / 2.0 if hotspot_center_s is None else hotspot_center_s
        width = horizon_s / 8.0 if hotspot_width_s is None else hotspot_width_s
        for s in range(n_stations):
            if s == hotspot_station:
                env = per_station_rate[s] * (1.0 + hotspot_boost)
                t = thinned_arrivals(
                    lambda tt: hotspot_rate(tt, per_station_rate[s],
                                            hotspot_boost, center, width),
                    env, horizon_s, rng)
            else:
                t = poisson_arrivals(per_station_rate[s], horizon_s, rng)
            times.append(t)
            stations.append(np.full(len(t), s, dtype=np.int64))
    else:
        raise ValueError(f"unknown arrival model {arrival!r}")

    t = np.concatenate(times) if times else np.empty(0)
    st = np.concatenate(stations) if stations else np.empty(0, dtype=np.int64)
    order = np.argsort(t, kind="stable")
    t, st = t[order], st[order]
    n = len(t)
    return RequestBatch(
        arrival_s=t,
        prompt_len=sample_prompt_lens(n, rng, prompt_median, prompt_sigma,
                                      prompt_max),
        decode_len=sample_decode_lens(n, rng, decode_mean, decode_max),
        station=st,
    )


def stream_requests(
    rng: np.random.Generator,
    rate_fn,
    rate_max_rps: float,
    horizon_s: float,
    n_stations: int,
    *,
    shard_s: float = 600.0,
    station_weights: np.ndarray | None = None,
    prompt_median: int = 256,
    prompt_sigma: float = 1.0,
    prompt_max: int = 4096,
    decode_mean: int = 64,
    decode_max: int = 1024,
) -> tuple[RequestBatch, int]:
    """Planet-scale trace sampling with bounded peak memory.

    The envelope process (``rate_max_rps``, potentially millions of
    users over the horizon) streams through :func:`stream_arrivals` in
    bounded shards; only arrivals kept by the thinning law
    ``rate_fn(t)/rate_max`` materialize into the returned
    :class:`RequestBatch`.  Stations are sampled i.i.d. by
    ``station_weights`` for the kept arrivals (valid because thinning
    and station assignment are independent), lengths with the same
    heavy-tail samplers as :func:`sample_requests`.

    Returns:
        ``(batch, n_generated)`` — the kept-request trace and the
        total number of envelope arrivals generated (the offered-user
        count the federation bench reports at the 1e6+ scale).
    """
    t, n_generated = stream_arrivals(rate_fn, rate_max_rps, horizon_s,
                                     rng, shard_s=shard_s)
    n = len(t)
    weights = (np.full(n_stations, 1.0 / n_stations)
               if station_weights is None
               else np.asarray(station_weights, dtype=np.float64))
    weights = weights / weights.sum()
    batch = RequestBatch(
        arrival_s=t,
        prompt_len=sample_prompt_lens(n, rng, prompt_median, prompt_sigma,
                                      prompt_max),
        decode_len=sample_decode_lens(n, rng, decode_mean, decode_max),
        station=rng.choice(n_stations, size=n, p=weights),
    )
    return batch, n_generated
