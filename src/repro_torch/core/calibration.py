"""Service times of the Eq. 43 terms: the load side of calibration.

Counterpart of ``repro.core.calibration`` for what the engine and the
fleet simulator consume: the versioned, content-hashed
:class:`ServiceTable` (read from ``calibration_tables/``, the port's own
copy of the reference's committed tables), :func:`load_table`, the
:class:`ServiceModel` facade and :func:`resolve_service_model`.  Mode
``"analytic"`` reproduces the FLOP-count constants bit-for-bit; mode
``"calibrated"`` reads a table: per-expert service seconds, per-satellite
speed multipliers and batch-size-dependent decode rates,

    gateway_step_s(B) = max(B * flops_tok / f,
                            (weight_bytes + B * token_bytes) / bw) / eff
    decode_rate(B)    = B / gateway_step_s(B)        # monotone in B

The measuring side (``host_probe``, ``measure_components``,
``derive_table``: timing the port's kernels on the card) is not ported
yet, so the committed tables are the reference's.  Host numpy, held
bitwise to the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np

from .latency import ComputeConfig
from .workload import MoEWorkload

#: Schema version; bump on any field-meaning change so stale committed
#: tables fail loudly instead of silently mis-predicting.
TABLE_VERSION = 1

#: Committed, versioned tables live inside the package (a copy of the
#: reference's, pinned to it by content hash in the tests).
TABLE_DIR = Path(__file__).resolve().parent / "calibration_tables"

#: TPU v5e bytes-per-FLOP balance (HBM_BW / PEAK_FLOPS).  Satellite memory
#: bandwidth defaults to the onboard FLOP rate times this balance, keeping
#: the arithmetic-intensity threshold of the satellite roofline identical
#: to the measured accelerator's.
SAT_BYTES_PER_FLOP = 819e9 / 197e12


def _canonical_json(d: dict) -> str:
    """Stable serialization used for hashing and on-disk storage."""
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class ServiceTable:
    """One calibrated (workload x host) service-time table.

    Attributes:
        version: Schema version (:data:`TABLE_VERSION`).
        name: Registry name, usually the model-config arch id.
        jax_version: jax that produced the measurements.
        backend: jax backend the measurements ran on (``cpu``/``tpu``).
        impl: Kernel implementation measured — ``"ref"`` (jnp oracles,
            the off-TPU default) or ``"pallas"`` (Mosaic kernels).
        ctx_len: Attention context the gateway sweep used.
        batches: Decode batch sizes of the gateway sweep.
        workload: ``dataclasses.asdict`` of the :class:`MoEWorkload`.
        host: Probed host rates ``{"flops_per_s", "bw_bytes_per_s"}``.
        sat: Satellite rates the derived times target (same keys).
        energy: Per-component FLOP/byte energy proxies in deployment
            (workload-dtype) units.
        measured_s: Raw kernel wall timings, seconds.
        efficiency: Per-component achieved fraction of the host roofline.
        derived: Satellite-unit service times — ``expert_s`` (one entry
            per expert), ``gateway_s_by_batch`` (per-call step seconds at
            the swept batches), ``head_s``.
        meta: Free-form extras (iteration counts, dry-run attachment).
        table_hash: sha256 of the canonical JSON minus this field.
    """

    version: int
    name: str
    jax_version: str
    backend: str
    impl: str
    ctx_len: int
    batches: tuple[int, ...]
    workload: dict
    host: dict
    sat: dict
    energy: dict
    measured_s: dict
    efficiency: dict
    derived: dict
    meta: dict = dataclasses.field(default_factory=dict)
    table_hash: str = ""

    def to_dict(self) -> dict:
        """Plain-dict form (hash recomputed, lists for tuples)."""
        d = dataclasses.asdict(self)
        d["batches"] = [int(b) for b in self.batches]
        d["table_hash"] = self.compute_hash()
        return d

    def compute_hash(self) -> str:
        """Content hash over every field except ``table_hash`` itself."""
        d = dataclasses.asdict(self)
        d["batches"] = [int(b) for b in self.batches]
        d.pop("table_hash")
        return hashlib.sha256(_canonical_json(d).encode()).hexdigest()[:16]

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceTable":
        """Rebuild from a stored dict, verifying version and hash."""
        d = dict(d)
        if d.get("version") != TABLE_VERSION:
            raise ValueError(
                f"service table {d.get('name')!r} has version "
                f"{d.get('version')}, expected {TABLE_VERSION} — re-run "
                "calibration (benchmarks/bench_calibration.py --refresh)")
        d["batches"] = tuple(int(b) for b in d["batches"])
        table = cls(**d)
        want = table.compute_hash()
        if d.get("table_hash") and d["table_hash"] != want:
            raise ValueError(
                f"service table {d.get('name')!r} content hash mismatch "
                f"({d['table_hash']} != {want}) — the file was edited by "
                "hand or corrupted; re-run calibration")
        return table

    def workload_obj(self) -> MoEWorkload:
        """The :class:`MoEWorkload` the table was calibrated for."""
        return MoEWorkload(**self.workload)


# --------------------------------------------------------------------- #
# Persistence + provenance
# --------------------------------------------------------------------- #


def table_path(name: str, table_dir: Path | str | None = None) -> Path:
    """On-disk location of a named table."""
    base = Path(table_dir) if table_dir is not None else TABLE_DIR
    return base / f"{name}.json"


def save_table(table: ServiceTable,
               table_dir: Path | str | None = None) -> Path:
    """Write a table (canonical JSON, hash included) and return its path."""
    path = table_path(table.name, table_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    d = table.to_dict()
    path.write_text(json.dumps(d, sort_keys=True, indent=1) + "\n")
    return path


def load_table(name: str,
               table_dir: Path | str | None = None) -> ServiceTable:
    """Load a committed table by name (version and content hash checked)."""
    path = table_path(name, table_dir)
    if not path.exists():
        raise FileNotFoundError(
            f"no calibration table {name!r} at {path} — generate one with "
            "the reference's benchmarks/bench_calibration.py --refresh")
    return ServiceTable.from_dict(json.loads(path.read_text()))


def list_tables(table_dir: Path | str | None = None) -> list[str]:
    """Names of every committed table."""
    base = Path(table_dir) if table_dir is not None else TABLE_DIR
    if not base.exists():
        return []
    return sorted(p.stem for p in base.glob("*.json"))


# --------------------------------------------------------------------- #
# ServiceModel: the facade the engine and FleetSim consume
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Resolved service-time source for one engine / fleet pass.

    Mode ``"analytic"`` computes exactly the pre-calibration constants
    (``compute.latency_s`` of the workload FLOPs — bit-identical to the
    legacy path, as the parity tests pin).  Mode ``"calibrated"`` reads a
    :class:`ServiceTable`: per-expert service seconds, per-satellite
    speed multipliers, batch-size-dependent decode rates.

    Attributes:
        workload: FLOP/byte model of the served MoE.
        compute: Satellite FLOPs->seconds conversion (analytic + the
            satellite-unit roofline rates).
        mode: ``"analytic"`` or ``"calibrated"``.
        table: Calibrated table (required in calibrated mode).
        units: ``"satellite"`` projects the table to onboard-compute
            rates; ``"host"`` keeps the measured host's rates (the
            validation harness compares those against real step times).
        sat_speed: Optional per-satellite relative speed multipliers
            (1.0 = nominal); service on satellite v scales by
            ``1 / sat_speed[v]``.
    """

    workload: MoEWorkload
    compute: ComputeConfig
    mode: str = "analytic"
    table: ServiceTable | None = None
    units: str = "satellite"
    sat_speed: tuple | None = None

    @classmethod
    def analytic(cls, workload: MoEWorkload,
                 compute: ComputeConfig) -> "ServiceModel":
        """The bit-parity analytic constants."""
        return cls(workload=workload, compute=compute, mode="analytic")

    @classmethod
    def calibrated(cls, workload: MoEWorkload, compute: ComputeConfig,
                   table: ServiceTable, units: str = "satellite",
                   sat_speed=None) -> "ServiceModel":
        """Kernel-calibrated service times from a :class:`ServiceTable`."""
        if units not in ("satellite", "host"):
            raise ValueError(f"units must be 'satellite' or 'host', "
                             f"got {units!r}")
        if table.workload.get("n_experts") != workload.n_experts:
            raise ValueError(
                f"table {table.name!r} was calibrated for "
                f"{table.workload.get('n_experts')} experts, workload has "
                f"{workload.n_experts}")
        speed = None if sat_speed is None else tuple(float(s)
                                                     for s in sat_speed)
        return cls(workload=workload, compute=compute, mode="calibrated",
                   table=table, units=units, sat_speed=speed)

    def __post_init__(self):
        if self.mode not in ("analytic", "calibrated"):
            raise ValueError(f"unknown service model mode {self.mode!r}")
        if self.mode == "calibrated" and self.table is None:
            raise ValueError("calibrated mode needs a ServiceTable")

    # -- mode predicates -------------------------------------------------
    @property
    def per_satellite(self) -> bool:
        """True when service is per-expert / per-satellite (calibrated)."""
        return self.mode == "calibrated"

    # -- internal rates --------------------------------------------------
    def _rates(self) -> dict:
        if self.units == "host":
            return {"flops_per_s": self.table.host["flops_per_s"],
                    "bw_bytes_per_s": self.table.host["bw_bytes_per_s"]}
        return self.table.sat

    # -- gateway ---------------------------------------------------------
    def gateway_step_s(self, ctx_len: int, batch=1):
        """Gateway step seconds for a decode batch (scalar or array).

        Calibrated satellite units: the decode-attention roofline with
        weight reads amortized over the batch, degraded by the measured
        gateway efficiency.  Host units: the measured kernel timing
        itself where the (ctx, batch) point was swept, the host roofline
        / efficiency otherwise.  Analytic:
        ``batch * latency_s(gateway_flops)``.
        """
        b = np.asarray(batch, dtype=np.float64)
        if self.mode == "analytic":
            return b * self.compute.latency_s(
                self.workload.gateway_flops(ctx_len))
        if self.units == "host":
            out = np.vectorize(
                lambda x: self._host_gateway_step(ctx_len, float(x)))(b)
            return float(out) if np.ndim(batch) == 0 else out
        r, eff = self._rates(), self.table.efficiency["gateway"]
        w = self.workload
        ideal = np.maximum(
            b * w.gateway_flops(ctx_len) / r["flops_per_s"],
            (w.gateway_weight_bytes + b * w.gateway_token_bytes(ctx_len))
            / r["bw_bytes_per_s"])
        return ideal / eff

    def _host_gateway_step(self, ctx_len: int, b: float) -> float:
        """Measured gateway step on the calibration host (exact lookup
        at swept points, roofline/efficiency fallback elsewhere)."""
        ms = self.table.measured_s["gateway_by_batch"]
        if ctx_len == self.table.ctx_len and b == int(b) \
                and str(int(b)) in ms:
            return float(ms[str(int(b))])
        r, eff = self._rates(), self.table.efficiency["gateway"]
        w = self.workload
        ideal = max(b * w.gateway_flops(ctx_len) / r["flops_per_s"],
                    (w.gateway_weight_bytes
                     + b * w.gateway_token_bytes(ctx_len))
                    / r["bw_bytes_per_s"])
        return ideal / eff

    def gateway_s(self, ctx_len: int, batch=1):
        """Per-token amortized gateway service seconds.

        At ``batch=1`` (and analytic mode always) this is the scalar the
        engine adds per layer; larger batches amortize the weight reads.
        """
        if self.mode == "analytic":
            return self.compute.latency_s(self.workload.gateway_flops(ctx_len))
        b = np.asarray(batch, dtype=np.float64)
        out = self.gateway_step_s(ctx_len, batch) / np.maximum(b, 1.0)
        return float(out) if np.ndim(batch) == 0 else out

    def decode_rate(self, batch, ctx_len: int | None = None):
        """Decode tokens/second at a given batch size (monotone in B)."""
        ctx = ctx_len if ctx_len is not None else (
            self.table.ctx_len if self.table is not None else 1024)
        b = np.asarray(batch, dtype=np.float64)
        return b / self.gateway_step_s(ctx, batch)

    def batch_speedup(self, b_max: int, ctx_len: int = 1024) -> np.ndarray:
        """(b_max,) relative per-token decode speedup at batch 1..b_max.

        ``speedup[b-1] = decode_rate(b) / decode_rate(1)``, clamped
        monotone non-decreasing with ``speedup[0] = 1`` exactly — the
        table the continuous-batching queue law interpolates (see
        the reference's ``traffic.batching``).  Calibrated mode reads the
        measured decode-attention roofline; analytic mode (whose
        ``decode_rate`` is deliberately flat — the bit-parity constants
        bill ``batch * latency_s``) projects the same roofline shape at
        the satellite-unit byte/FLOP balance (``SAT_BYTES_PER_FLOP``):
        weight reads amortize over the batch until the compute term
        takes over.
        """
        b = np.arange(1, int(b_max) + 1, dtype=np.float64)
        if self.mode == "calibrated":
            rate = np.asarray(self.decode_rate(b, ctx_len),
                              dtype=np.float64)
        else:
            w, f = self.workload, self.compute.flops_per_s
            bw = f * SAT_BYTES_PER_FLOP
            step = np.maximum(
                b * w.gateway_flops(ctx_len) / f,
                (w.gateway_weight_bytes + b * w.gateway_token_bytes(ctx_len))
                / bw)
            rate = b / step
        s = np.maximum.accumulate(np.maximum(rate / rate[0], 1.0))
        s[0] = 1.0
        return s

    # -- experts ---------------------------------------------------------
    def expert_s(self) -> np.ndarray:
        """(n_experts,) per-expert service seconds at nominal speed.

        Host units return the measured per-visit kernel time directly —
        the number the validation harness must predict real step times
        with; satellite units return the roofline-projected table.
        """
        i = self.workload.n_experts
        if self.mode == "analytic":
            return np.full(i, self.expert_scalar, dtype=np.float64)
        if self.units == "host":
            return np.full(i, float(self.table.measured_s["expert_visit"]),
                           dtype=np.float64)
        return np.asarray(self.table.derived["expert_s"], dtype=np.float64)

    @property
    def expert_scalar(self) -> float:
        """Scalar expert service: exact analytic value, or the table mean."""
        if self.mode == "analytic":
            return self.compute.latency_s(self.workload.expert_flops)
        return float(np.mean(self.expert_s()))

    # -- head ------------------------------------------------------------
    @property
    def head_s(self) -> float:
        """LM-head service seconds per token."""
        if self.mode == "analytic":
            return self.compute.latency_s(self.workload.lm_head_flops)
        if self.units == "host":
            return float(self.table.measured_s["head_token"])
        return float(self.table.derived["head_s"])

    # -- satellite heterogeneity -----------------------------------------
    def inv_speed(self, n_sats: int) -> np.ndarray:
        """(n_sats,) per-satellite service multipliers (1 / speed)."""
        if self.sat_speed is None:
            return np.ones(n_sats, dtype=np.float64)
        speed = np.asarray(self.sat_speed, dtype=np.float64)
        if speed.shape != (n_sats,):
            raise ValueError(
                f"sat_speed has {speed.shape[0]} entries for {n_sats} "
                "satellites")
        if np.any(speed <= 0):
            raise ValueError("sat_speed entries must be positive")
        return 1.0 / speed

    # -- energy proxies ---------------------------------------------------
    def energy_per_token(self, ctx_len: int) -> dict:
        """Per-token FLOP/byte energy proxies (gateway + K experts + head)."""
        w = self.workload
        flops = (w.gateway_flops(ctx_len) + w.top_k * w.expert_flops
                 + w.lm_head_flops)
        nbytes = (w.gateway_bytes(ctx_len) + w.top_k * w.expert_bytes
                  + w.lm_head_bytes)
        return {"flops": float(flops), "bytes": float(nbytes)}

    # -- provenance -------------------------------------------------------
    def describe(self) -> dict:
        """Resolved provenance of this model (mode, table hash, units)."""
        d = {"mode": self.mode, "units": self.units}
        if self.table is not None:
            d["table"] = self.table.name
            d["table_hash"] = (self.table.table_hash
                               or self.table.compute_hash())
            d["impl"] = self.table.impl
        return d


def resolve_service_model(service_model, workload: MoEWorkload,
                          compute: ComputeConfig) -> ServiceModel:
    """Normalize the ``service_model=`` argument of the public sweeps.

    ``None`` and ``"analytic"`` resolve to the bit-parity analytic model;
    a :class:`ServiceModel` passes through.  The string ``"calibrated"``
    is rejected with a pointer — a table must be named explicitly.
    """
    if service_model is None or service_model == "analytic":
        return ServiceModel.analytic(workload, compute)
    if isinstance(service_model, ServiceModel):
        return service_model
    if service_model == "calibrated":
        raise ValueError(
            "pass a ServiceModel instance for calibrated mode, e.g. "
            "ServiceModel.calibrated(workload, compute, "
            "load_table('llama-moe-3.5b'))")
    raise TypeError(f"service_model must be None, 'analytic' or a "
                    f"ServiceModel, got {type(service_model).__name__}")
