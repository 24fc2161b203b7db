"""Polar LEO constellation model (paper Sec. II).

Implements the satellite set V (Eq. 1), the time-varying ISL graph
G(n) = {V, E(n)} (Eq. 2-3) and the geometry needed by the latency model
(central angles for Eq. 5, LoS angular rates for the tracking gate).

All geometry is computed in the ECI frame: laser ISLs depend only on the
relative satellite geometry, so Earth rotation is irrelevant here.
Units: meters, seconds, radians.

A copy of ``repro.core.constellation`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# Physical constants.
EARTH_RADIUS_M = 6_371_000.0          # R_E, Earth mean radius
MU_EARTH = 3.986004418e14             # standard gravitational parameter [m^3/s^2]
SPEED_OF_LIGHT = 299_792_458.0        # c [m/s]


@dataclasses.dataclass(frozen=True)
class ConstellationConfig:
    """Walker-star polar constellation, paper Sec. VII-A defaults."""

    n_planes: int = 33                 # N_x orbital planes
    sats_per_plane: int = 32           # N_y satellites per plane
    altitude_km: float = 550.0         # H
    inclination_deg: float = 87.0
    phasing: int = 13                  # Walker phasing parameter F
    n_slots: int = 200                 # N_T discrete time slots (one period)
    angular_rate_threshold: float = 0.12   # theta_dot_delta [rad/s]
    survival_prob: float = 0.95        # P^sw, Bernoulli link survival
    cross_seam_isls: bool = True       # include candidate ISLs between the
    #   counter-rotating planes N_x-1 and 0.  The paper's "seam" (Fig. 1)
    #   emerges physically: those partners are usually Earth-occluded or
    #   far apart, and during close passes the ~2v relative motion drives
    #   the PAT slew rate up so the angular-rate gate (Eq. 2) bites, while
    #   co-rotating neighbours slew at ~1e-3 rad/s and always pass.
    grazing_altitude_km: float = 80.0  # atmosphere margin for Earth occlusion

    @property
    def n_sats(self) -> int:
        return self.n_planes * self.sats_per_plane

    @property
    def semi_major_axis_m(self) -> float:
        return EARTH_RADIUS_M + self.altitude_km * 1e3

    @property
    def orbital_period_s(self) -> float:
        a = self.semi_major_axis_m
        return 2.0 * np.pi * np.sqrt(a**3 / MU_EARTH)

    @property
    def orbital_rate(self) -> float:
        """Mean motion [rad/s]."""
        return 2.0 * np.pi / self.orbital_period_s

    @staticmethod
    def scaled(n_planes: int, sats_per_plane: int, **kw) -> "ConstellationConfig":
        """Config with the paper's *relative* phasing (F=13 at 33x32 keeps
        the inter-plane partner offset at ~4.4 deg; preserve that fraction
        when resizing the constellation for sweeps/tests)."""
        frac = 13.0 / (33 * 32)
        phasing = max(1, round(frac * n_planes * sats_per_plane))
        return ConstellationConfig(
            n_planes=n_planes, sats_per_plane=sats_per_plane,
            phasing=phasing, **kw,
        )

    def sat_index(self, x: int, y: int) -> int:
        """Node index of satellite (x, y) — plane-major ordering."""
        return x * self.sats_per_plane + y

    def sat_coord(self, idx: int) -> tuple[int, int]:
        return divmod(idx, self.sats_per_plane)

    def slot_times(self) -> np.ndarray:
        """Slot start times spanning one orbital period."""
        return np.arange(self.n_slots) * (self.orbital_period_s / self.n_slots)


class Constellation:
    """Geometry + static (pre-outage) connectivity of the constellation."""

    def __init__(self, cfg: ConstellationConfig):
        self.cfg = cfg

    # ----------------------------------------------------------------- #
    # Kinematics
    # ----------------------------------------------------------------- #
    def positions(self, t: float | np.ndarray) -> np.ndarray:
        """ECI positions of all satellites at time(s) ``t``.

        Returns array of shape (..., n_sats, 3) in meters.
        """
        cfg = self.cfg
        t = np.asarray(t, dtype=np.float64)
        x = np.arange(cfg.n_planes)
        y = np.arange(cfg.sats_per_plane)

        # Walker-star: RAAN spread over pi; phasing offsets the along-track
        # argument of latitude between adjacent planes.
        raan = np.pi * x / cfg.n_planes                                 # (Nx,)
        phase = (
            2.0 * np.pi * y[None, :] / cfg.sats_per_plane
            + 2.0 * np.pi * cfg.phasing * x[:, None] / (cfg.n_planes * cfg.sats_per_plane)
        )                                                               # (Nx, Ny)

        u = phase[None, ...] + cfg.orbital_rate * t[..., None, None]    # (..., Nx, Ny)
        inc = np.deg2rad(cfg.inclination_deg)
        a = cfg.semi_major_axis_m

        cu, su = np.cos(u), np.sin(u)
        cO, sO = np.cos(raan), np.sin(raan)
        ci, si = np.cos(inc), np.sin(inc)

        # Standard circular-orbit ECI coordinates.
        px = a * (cu * cO[:, None] - su * sO[:, None] * ci)
        py = a * (cu * sO[:, None] + su * cO[:, None] * ci)
        pz = a * (su * si)
        pos = np.stack([px, py, pz], axis=-1)                           # (..., Nx, Ny, 3)
        return pos.reshape(*t.shape, cfg.n_sats, 3) if t.shape else pos.reshape(cfg.n_sats, 3)

    # ----------------------------------------------------------------- #
    # Static edge list (the cylindrical mesh, Fig. 5)
    # ----------------------------------------------------------------- #
    @cached_property
    def edges(self) -> np.ndarray:
        """Static candidate ISLs, shape (n_edges, 2) of node indices.

        Each satellite has up to 4 duplex ISLs: two intra-orbit (ring
        neighbours within the plane) and two inter-orbit (same slot index in
        adjacent planes).  Candidate links across the counter-rotating seam
        (x = N_x-1 <-> x = 0) are included iff ``cfg.cross_seam_isls``; they
        are then gated per-slot by the angular-rate test of Eq. 2.
        """
        cfg = self.cfg
        out: list[tuple[int, int]] = []
        for x in range(cfg.n_planes):
            for y in range(cfg.sats_per_plane):
                u = cfg.sat_index(x, y)
                # intra-orbit ring neighbour
                out.append((u, cfg.sat_index(x, (y + 1) % cfg.sats_per_plane)))
                # inter-orbit neighbour (eastward)
                if x + 1 < cfg.n_planes:
                    out.append((u, cfg.sat_index(x + 1, y)))
                elif cfg.cross_seam_isls:
                    out.append((u, cfg.sat_index(0, y)))
        return np.asarray(out, dtype=np.int64)

    @cached_property
    def intra_orbit_mask(self) -> np.ndarray:
        """Boolean mask over ``edges``: True for intra-orbit ISLs."""
        e = self.edges
        px = e[:, 0] // self.cfg.sats_per_plane
        qx = e[:, 1] // self.cfg.sats_per_plane
        return px == qx

    @cached_property
    def seam_mask(self) -> np.ndarray:
        """Boolean mask over ``edges``: True for cross-seam (counter-rotating)
        candidate ISLs."""
        e = self.edges
        px = e[:, 0] // self.cfg.sats_per_plane
        qx = e[:, 1] // self.cfg.sats_per_plane
        hi = self.cfg.n_planes - 1
        return ((px == hi) & (qx == 0)) | ((px == 0) & (qx == hi))

    # ----------------------------------------------------------------- #
    # Per-slot edge geometry
    # ----------------------------------------------------------------- #
    def central_angles(self, t: float) -> np.ndarray:
        """Central angle theta_{u,v}(t) for every candidate edge (Eq. 5 input)."""
        pos = self.positions(float(t))
        e = self.edges
        pu = pos[e[:, 0]]
        pv = pos[e[:, 1]]
        a = self.cfg.semi_major_axis_m
        cosang = np.einsum("ij,ij->i", pu, pv) / (a * a)
        return np.arccos(np.clip(cosang, -1.0, 1.0))

    def edge_distances(self, t: float) -> np.ndarray:
        """Chord (line-of-sight) distance per candidate edge [m] (Eq. 5)."""
        theta = self.central_angles(t)
        return 2.0 * self.cfg.semi_major_axis_m * np.sin(theta / 2.0)

    def los_angular_rates(self, t: float, dt: float = 1.0) -> np.ndarray:
        """|d/dt| of the LoS direction per candidate edge [rad/s].

        Numerical derivative of the unit LoS vector: the PAT system has to
        slew at this rate to keep the laser pointed (Eq. 2 gate).
        """
        e = self.edges

        def unit_los(tt: float) -> np.ndarray:
            pos = self.positions(float(tt))
            d = pos[e[:, 1]] - pos[e[:, 0]]
            return d / np.linalg.norm(d, axis=-1, keepdims=True)

        e0 = unit_los(t)
        e1 = unit_los(t + dt)
        dot = np.clip(np.einsum("ij,ij->i", e0, e1), -1.0, 1.0)
        return np.arccos(dot) / dt

    # ----------------------------------------------------------------- #
    # Time-varying feasibility (Eq. 2-3)
    # ----------------------------------------------------------------- #
    @property
    def max_central_angle(self) -> float:
        """Largest central angle with an unobstructed LoS (Earth + atmosphere
        grazing): theta_max = 2*arccos((R_E + h_graze) / a)."""
        cfg = self.cfg
        ratio = (EARTH_RADIUS_M + cfg.grazing_altitude_km * 1e3) / cfg.semi_major_axis_m
        return 2.0 * np.arccos(np.clip(ratio, -1.0, 1.0))

    def occlusion_feasible(self, t: float) -> np.ndarray:
        """LoS not blocked by the Earth (relevant only for seam partners;
        adjacent co-rotating neighbours are always within a few degrees)."""
        return self.central_angles(t) <= self.max_central_angle

    def tracking_feasible(self, t: float) -> np.ndarray:
        """Deterministic gates: LoS exists AND theta_dot <= threshold (Eq. 2)."""
        ok = self.los_angular_rates(t) <= self.cfg.angular_rate_threshold
        return ok & self.occlusion_feasible(t)

    def sample_edge_mask(self, t: float, rng: np.random.Generator) -> np.ndarray:
        """One realization of E(n): PAT gate AND Bernoulli survival (Eq. 2-3)."""
        feas = self.tracking_feasible(t)
        xi = rng.random(feas.shape[0]) < self.cfg.survival_prob
        return feas & xi
