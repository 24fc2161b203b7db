"""User -> ground gateway -> ingress-satellite mapping.

Counterpart of ``repro.traffic.ground``: host numpy, the reference's
arithmetic (held to it bitwise by ``tests/test_torch_ground.py``).

Ground gateways sit on the rotating Earth; satellites are propagated in
ECI by :class:`repro_torch.core.Constellation`.  Per topology slot we rotate
each gateway into ECI (Earth spin about +z — consistent with the polar
Walker geometry, whose z axis is the rotation axis), compute elevation
angles to every satellite, and keep the *ranked* top-R visible
satellites per gateway (descending elevation) rather than just the
argmax: rank 0 is the ingress node, the deeper ranks feed fallback
routing and the admission controller's gateway-retry path.  Uplink
latency = slant range / c + the token transmission time at the (slower)
ground-to-space rate.

Gateways are also connected to each other terrestrially (fiber
backbone): :attr:`GroundSegment.ground_delay_s` holds the great-circle
propagation delay between every gateway pair, and
:meth:`GroundSegment.retry_stations` ranks, per (slot, origin gateway),
the alternative gateways a shed request should retry at — ordered by
terrestrial-forward + best-uplink latency, invisible gateways last.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Constellation, LinkConfig
from ..core.constellation import EARTH_RADIUS_M, SPEED_OF_LIGHT

EARTH_ROTATION_RAD_S = 7.2921159e-5   # sidereal rotation rate
#: Effective speed of light in the terrestrial fiber backbone (refractive
#: index ~1.5) used for gateway-to-gateway forwarding of retried requests.
FIBER_LIGHT_FRACTION = 0.66


@dataclasses.dataclass(frozen=True)
class GroundStation:
    """A ground gateway site (user traffic aggregation point).

    Attributes:
        name: Human-readable region label.
        lat_deg: Geodetic latitude, degrees.
        lon_deg: Longitude, degrees east.
    """

    name: str
    lat_deg: float
    lon_deg: float

    def ecef(self) -> np.ndarray:
        """(3,) position on the (spherical) Earth surface, meters."""
        lat = np.deg2rad(self.lat_deg)
        lon = np.deg2rad(self.lon_deg)
        return EARTH_RADIUS_M * np.array([
            np.cos(lat) * np.cos(lon),
            np.cos(lat) * np.sin(lon),
            np.sin(lat),
        ])


# A default global gateway set: one aggregation site per macro-region,
# spread in longitude so diurnal scenarios sweep around the planet.
DEFAULT_STATIONS: tuple[GroundStation, ...] = (
    GroundStation("north-america", 40.0, -100.0),
    GroundStation("south-america", -15.0, -55.0),
    GroundStation("europe", 50.0, 10.0),
    GroundStation("africa", 0.0, 25.0),
    GroundStation("south-asia", 20.0, 78.0),
    GroundStation("east-asia", 35.0, 115.0),
    GroundStation("oceania", -30.0, 140.0),
    GroundStation("polar-research", 78.0, 15.0),
)


def ground_delay_table(stations: tuple[GroundStation, ...]) -> np.ndarray:
    """(S, S) terrestrial forwarding delay between gateways, seconds.

    Great-circle distance on the spherical Earth divided by the fiber
    propagation speed (``FIBER_LIGHT_FRACTION`` * c).  Diagonal is zero.
    """
    pos = np.stack([s.ecef() for s in stations])                 # (S, 3)
    unit = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    cosang = np.clip(unit @ unit.T, -1.0, 1.0)
    arc_m = EARTH_RADIUS_M * np.arccos(cosang)
    np.fill_diagonal(arc_m, 0.0)          # arccos noise on the diagonal
    return arc_m / (FIBER_LIGHT_FRACTION * SPEED_OF_LIGHT)


@dataclasses.dataclass
class GroundSegment:
    """Per-slot ranked ingress mapping for a set of ground stations.

    The rank axis (size ``n_ranked``) orders each station's visible
    satellites by descending elevation; rank 0 is the classic
    best-elevation ingress choice.

    Attributes:
        stations: The gateway sites, index = station id everywhere below.
        ingress_sat: (n_slots, S) best visible satellite per station
            (-1 when none is visible).  Equals ``ingress_ranked[..., 0]``.
        uplink_s: (n_slots, S) uplink latency to that satellite (+inf if
            none visible).
        elevation_rad: (n_slots, S) elevation of the chosen satellite.
        min_elevation_deg: Visibility mask threshold used at build time.
        ingress_ranked: (n_slots, S, n_ranked) satellites by descending
            elevation, -1 past the last visible one.
        uplink_ranked_s: (n_slots, S, n_ranked) matching uplink latencies
            (+inf where no satellite).
        elevation_ranked_rad: (n_slots, S, n_ranked) matching elevations.
        ground_delay_s: (S, S) terrestrial gateway-to-gateway forwarding
            delay (see :func:`ground_delay_table`).
    """

    stations: tuple[GroundStation, ...]
    ingress_sat: np.ndarray
    uplink_s: np.ndarray
    elevation_rad: np.ndarray
    min_elevation_deg: float
    ingress_ranked: np.ndarray | None = None
    uplink_ranked_s: np.ndarray | None = None
    elevation_ranked_rad: np.ndarray | None = None
    ground_delay_s: np.ndarray | None = None

    def __post_init__(self):
        """Backfill the ranked/terrestrial tables for legacy constructors
        that only supply the argmax (rank-0) arrays."""
        if self.ingress_ranked is None:
            self.ingress_ranked = self.ingress_sat[..., None]
            self.uplink_ranked_s = self.uplink_s[..., None]
            self.elevation_ranked_rad = self.elevation_rad[..., None]
        if self.ground_delay_s is None:
            self.ground_delay_s = ground_delay_table(self.stations)

    @property
    def n_stations(self) -> int:
        """Number of ground gateway sites."""
        return len(self.stations)

    @property
    def n_slots(self) -> int:
        """Number of topology slots the tables were built for."""
        return self.ingress_sat.shape[0]

    @property
    def n_ranked(self) -> int:
        """Depth of the ranked-visibility table (satellites per station)."""
        return self.ingress_ranked.shape[2]

    def coverage(self) -> float:
        """Fraction of (slot, station) pairs with a visible satellite."""
        return float((self.ingress_sat >= 0).mean())

    def for_requests(self, slots: np.ndarray, station: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(ingress_sat, uplink_s) per request given its slot + station.

        Args:
            slots: (R,) topology slot of each request.
            station: (R,) originating gateway of each request.

        Returns:
            Two (R,) arrays: best-elevation ingress satellite (-1 if the
            station sees nothing) and the matching uplink latency.
        """
        slots = np.asarray(slots)
        station = np.asarray(station)
        return (self.ingress_sat[slots, station],
                self.uplink_s[slots, station])

    def ranked_for_requests(self, slots: np.ndarray, station: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Ranked (ingress sats, uplinks) per request.

        Args:
            slots: (R,) topology slot of each request.
            station: (R,) originating gateway of each request.

        Returns:
            (R, n_ranked) satellite ids (-1 pads the invisible tail) and
            (R, n_ranked) uplink latencies (+inf on the pads).
        """
        slots = np.asarray(slots)
        station = np.asarray(station)
        return (self.ingress_ranked[slots, station],
                self.uplink_ranked_s[slots, station])

    def retry_stations(self, slots: np.ndarray, origin: np.ndarray,
                       n_alternatives: int) -> np.ndarray:
        """Ranked alternative gateways for admission-rejected requests.

        For each request, the other gateways are ordered by the latency a
        retried request would pay to enter through them: terrestrial
        forwarding delay from the origin plus the candidate's best (rank
        0) uplink in that slot.  Gateways with no visible satellite sort
        last (their uplink is +inf, so the caller's feasibility mask —
        ``ingress_sat >= 0`` — rejects them).

        Args:
            slots: (R,) topology slot of each request.
            origin: (R,) gateway the request originally arrived at.
            n_alternatives: How many ranked alternatives to return.

        Returns:
            (R, n_alternatives) station indices, best retry target first.
            The origin itself never appears.
        """
        slots = np.asarray(slots)
        origin = np.asarray(origin)
        n_alt = min(n_alternatives, self.n_stations - 1)
        if n_alt <= 0:
            return np.empty((len(origin), 0), dtype=np.int64)
        score = self.uplink_s[slots] + self.ground_delay_s[origin]  # (R, S)
        order = np.argsort(score, axis=1, kind="stable")            # (R, S)
        # Drop the origin from every row (it may tie at +inf with
        # invisible gateways, so masking by score alone is not enough):
        # a stable sort on the "is origin" flag compacts it to the end.
        not_origin = order != origin[:, None]
        order = np.take_along_axis(
            order, np.argsort(~not_origin, axis=1, kind="stable"), axis=1)
        return order[:, :n_alt]


def build_ground_segment(
    constellation: Constellation,
    link: LinkConfig,
    stations: tuple[GroundStation, ...] = DEFAULT_STATIONS,
    min_elevation_deg: float = 25.0,
    uplink_rate_gbps: float = 10.0,
    slot_times: np.ndarray | None = None,
    n_ranked: int = 4,
) -> GroundSegment:
    """Compute the per-slot station -> ranked-ingress-satellite table.

    Args:
        constellation: Propagates satellite ECI positions per slot.
        link: Supplies the per-token payload size for the uplink
            transmission-time term.
        stations: Gateway sites (defaults to one per macro-region).
        min_elevation_deg: Satellites below this elevation are invisible.
        uplink_rate_gbps: Ground-to-space feeder rate (an order of
            magnitude below the optical ISL rate by default).
        slot_times: Optional explicit slot sample times (seconds);
            defaults to the constellation's own slot grid.
        n_ranked: Depth of the ranked-visibility table kept per station.

    Returns:
        A :class:`GroundSegment` with both the rank-0 (argmax) arrays and
        the full ranked tables populated.
    """
    cfg = constellation.cfg
    times = cfg.slot_times() if slot_times is None else np.asarray(slot_times)
    n_slots = len(times)
    n_st = len(stations)
    gs_ecef = np.stack([s.ecef() for s in stations])            # (S, 3)

    tx_s = (link.token_dim * link.bits_per_value) / (uplink_rate_gbps * 1e9)
    min_el = np.deg2rad(min_elevation_deg)
    n_ranked = max(1, min(n_ranked, cfg.n_sats))

    rows = np.arange(n_st)[:, None]
    ranked = np.full((n_slots, n_st, n_ranked), -1, dtype=np.int64)
    uplink_r = np.full((n_slots, n_st, n_ranked), np.inf, dtype=np.float64)
    elev_r = np.full((n_slots, n_st, n_ranked), -np.pi / 2, dtype=np.float64)
    for n, t in enumerate(times):
        sat_pos = constellation.positions(float(t))             # (V, 3)
        theta = EARTH_ROTATION_RAD_S * float(t)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        gs = gs_ecef @ rot.T                                    # (S, 3) in ECI
        los = sat_pos[None, :, :] - gs[:, None, :]              # (S, V, 3)
        rng_m = np.linalg.norm(los, axis=-1)
        up = gs / np.linalg.norm(gs, axis=-1, keepdims=True)
        sin_el = np.einsum("svi,si->sv", los, up) / rng_m
        el = np.arcsin(np.clip(sin_el, -1.0, 1.0))              # (S, V)
        el_masked = np.where(el >= min_el, el, -np.inf)
        order = np.argsort(-el_masked, axis=1, kind="stable")[:, :n_ranked]
        seen = np.isfinite(el_masked[rows, order])              # (S, n_ranked)
        ranked[n] = np.where(seen, order, -1)
        uplink_r[n] = np.where(
            seen, rng_m[rows, order] / SPEED_OF_LIGHT + tx_s, np.inf)
        elev_r[n] = np.where(seen, el[rows, order], -np.pi / 2)
    return GroundSegment(
        stations=tuple(stations),
        ingress_sat=ranked[..., 0].copy(),
        uplink_s=uplink_r[..., 0].copy(),
        elevation_rad=elev_r[..., 0].copy(),
        min_elevation_deg=min_elevation_deg,
        ingress_ranked=ranked, uplink_ranked_s=uplink_r,
        elevation_ranked_rad=elev_r,
        ground_delay_s=ground_delay_table(tuple(stations)),
    )


def rank_constellations(costs: np.ndarray) -> np.ndarray:
    """Deterministic cross-constellation preference order per request.

    The federation-level generalization of the per-constellation
    ``ingress_ranked`` table: given each constellation's ingress cost
    for each request (uplink + gateway hop; ``+inf`` marks a
    constellation whose ground segment cannot ingest the request at
    all), rank the constellations best-first.  A stable argsort breaks
    ties — equal costs, and the all-``+inf`` tail — by constellation
    index, so the federation scheduler's routing is reproducible
    across platforms.

    Args:
        costs: (K, R) per-constellation ingress cost per request
            (``np.inf`` = infeasible).

    Returns:
        (R, K) constellation indices, best first; infeasible
        constellations sort last (callers must still consult the cost
        to know where the feasible prefix ends).
    """
    costs = np.asarray(costs, dtype=np.float64)
    if costs.ndim != 2:
        raise ValueError(f"costs must be (K, R), got {costs.shape}")
    return np.argsort(costs, axis=0, kind="stable").T
