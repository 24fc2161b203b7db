"""Model-in-the-loop service times: calibrate Eq. 43 on the port's kernels.

Counterpart of ``repro.core.calibration``:

1. **Measure** (:func:`measure_components`) the port's kernels on a
   device: the ``gmm`` expert chain over (E, C, d) buckets, the
   ``decode_attention`` kernel swept over decode batch sizes, and the
   unembedding matmul (``torch.matmul``, as the reference leaves it to
   XLA); ``impl="cuda"`` times the CUDA kernels, ``impl="ref"`` their
   plain versions.  Timing is :func:`~repro_torch.kernels.ops.timed_call`,
   f32 with TF32 off.
2. **Cross with the roofline**: each component's ideal host time is
   ``max(flops / f_host, bytes / bw_host)`` against the rates
   :func:`host_probe` measures; ideal / measured is its efficiency,
   clipped to [``MIN_EFFICIENCY``, 1].
3. **Project to satellite units** (:func:`derive_table`): the paper's
   onboard compute and a bandwidth at the ``SAT_BYTES_PER_FLOP`` balance,
   divided by the efficiency.

:func:`derive_table`, :func:`verify_table` and :func:`attach_dryrun` are
pure host numpy and give the reference's table and hash for the same
inputs.  Tables keep the reference's field names, so that both packages
read each other's: the port writes the torch version under
``jax_version`` and ``"cuda"`` or ``"cpu"`` under ``backend``.  The
committed tables under ``calibration_tables/`` are the reference's
(copies pinned by hash in the tests); tables measured on an H100 live in
``calibration_tables/h100/``, which :func:`list_tables` does not glob.

The :class:`ServiceModel` facade is what the engine and the fleet
simulator consume.  Mode ``"analytic"`` reproduces the FLOP-count
constants bit-for-bit; mode ``"calibrated"`` reads a table: per-expert
service seconds, per-satellite speed multipliers and batch-size-dependent
decode rates,

    gateway_step_s(B) = max(B * flops_tok / f,
                            (weight_bytes + B * token_bytes) / bw) / eff
    decode_rate(B)    = B / gateway_step_s(B)        # monotone in B
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from .latency import ComputeConfig
from .workload import MoEWorkload

#: Schema version; bump on any field-meaning change so stale committed
#: tables fail loudly instead of silently mis-predicting.
TABLE_VERSION = 1

#: Committed, versioned tables live inside the package (a copy of the
#: reference's, pinned to it by content hash in the tests).
TABLE_DIR = Path(__file__).resolve().parent / "calibration_tables"

#: Decode batch sizes the gateway kernel is swept over.
DEFAULT_BATCHES = (1, 2, 4, 8, 16, 32)

#: TPU v5e bytes-per-FLOP balance (HBM_BW / PEAK_FLOPS).  Satellite memory
#: bandwidth defaults to the onboard FLOP rate times this balance, keeping
#: the arithmetic-intensity threshold of the satellite roofline identical
#: to the measured accelerator's.
SAT_BYTES_PER_FLOP = 819e9 / 197e12

#: Efficiency floor: a measurement slower than 10000x the roofline ideal
#: is treated as overhead noise, not signal.
MIN_EFFICIENCY = 1e-4

#: Tables loaded this process, name -> content hash (provenance feed for
#: benchmark JSON).
_LOADED_TABLES: dict[str, str] = {}


def _canonical_json(d: dict) -> str:
    """Stable serialization used for hashing and on-disk storage."""
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class ServiceTable:
    """One calibrated (workload x host) service-time table.

    Attributes:
        version: Schema version (:data:`TABLE_VERSION`).
        name: Registry name, usually the model-config arch id.
        jax_version: Framework version that produced the measurements
            (jax in the reference's tables, torch in the port's: the field
            keeps its name so that both packages read both).
        backend: Device the measurements ran on (``cpu``/``tpu`` in the
            reference's tables, ``cpu``/``cuda`` in the port's).
        impl: Kernel implementation measured — ``"ref"`` (plain versions:
            jnp oracles, or the port's plain PyTorch), ``"pallas"``
            (Mosaic kernels) or ``"cuda"`` (the port's CUDA kernels).
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
# Measurement: the port's kernels, synchronized wall time
# --------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def host_probe(n: int = 768, copy_mb: int = 32, iters: int = 5,
               device="cuda") -> tuple:
    """Probe the device's achievable (flops_per_s, bw_bytes_per_s).

    One f32 ``n x n`` matmul rates the FLOP ceiling and one big-array
    copy rates memory bandwidth (the reference's sizes); both are the
    denominators the measured kernel efficiencies are computed against,
    so they only need to be *consistent*, not data-sheet peaks.  On an
    H100 both are launch-bound and read far below its peaks.  Memoized
    per process and device.
    """
    from ..kernels.ops import timed_call

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=gen, dtype=torch.float32, device=dev)
    with _exact_f32():
        t_mm = timed_call(torch.matmul, a, a, iters=iters)
    flops_per_s = 2.0 * n ** 3 / t_mm

    m = (copy_mb * 1 << 20) // 4
    big = torch.zeros((m,), dtype=torch.float32, device=dev)
    factor = float(np.float32(1.0000001))
    t_cp = timed_call(lambda x: x * factor, big, iters=iters)
    bw = 2.0 * 4.0 * m / t_cp            # read + write
    return float(flops_per_s), float(bw)


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for CUDA matmuls inside the block (f32 is timed as f32)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _ideal_host(flops: float, nbytes: float, host: tuple) -> float:
    """Roofline max-rule ideal time on the probed host, seconds."""
    f, bw = host
    return max(flops / f, nbytes / bw)


def measure_components(workload: MoEWorkload, ctx_len: int,
                       batches: tuple[int, ...], impl: str,
                       iters: int = 3, rows_per_expert: int = 32,
                       device="cuda") -> dict:
    """Time the port's kernels for every service component on ``device``.

    Returns a dict with the raw wall timings (``measured_s``), the
    FLOP/byte energy of the *measured arrays* (``kernel_energy`` — f32,
    distinct from the deployment-dtype table energy) and the probed host
    rates, i.e. everything :func:`derive_table` needs to be pure; the
    keys and ``kernel_energy`` are the reference's.

    Args:
        workload: Shapes to measure (experts, heads, context...).
        ctx_len: KV-cache length for the decode-attention sweep.
        batches: Decode batch sizes to sweep the attention kernel over.
        impl: ``"ref"`` for the plain PyTorch versions or ``"cuda"`` for
            the CUDA kernels (``device`` must then be a CUDA device).
        iters: Best-of-N timing iterations per point.
        rows_per_expert: Bucket rows per expert in the gmm measurement
            (amortizes dispatch overhead over E*rows visits).
        device: Where the tensors live.
    """
    import torch.nn.functional as F

    from ..kernels import decode_attn, moe_gmm
    from ..kernels.ops import timed_call

    dev = torch.device(device)
    if impl == "ref":
        gmm_fn = moe_gmm.gmm_plain
        attn_fn = decode_attn.decode_attention_plain
    elif impl == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"impl='cuda' times the CUDA kernels; the "
                             f"tensors would live on {dev}")
        gmm_fn, attn_fn = moe_gmm.gmm, decode_attn.decode_attention
    else:
        raise ValueError(f"impl must be 'ref' or 'cuda', got {impl!r}")

    w = workload
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    e, d, f = w.n_experts, w.d_model, w.d_ff_expert
    c = rows_per_expert
    mats = 3 if w.gated_ffn else 2

    # -- expert FFN: the gated gmm chain over (E, C, d) buckets ----------
    xs, wg, wu, wd = normal(e, c, d), normal(e, d, f), normal(e, d, f), \
        normal(e, f, d)
    if w.gated_ffn:
        def ffn(x, g, u, dn):
            return gmm_fn(F.silu(gmm_fn(x, g)) * gmm_fn(x, u), dn)
        ffn_args = (xs, wg, wu, wd)
    else:
        def ffn(x, u, dn):
            return gmm_fn(F.silu(gmm_fn(x, u)), dn)
        ffn_args = (xs, wu, wd)
    with _exact_f32():
        t_ffn = timed_call(ffn, *ffn_args, iters=iters)
    del xs, wg, wu, wd, ffn_args
    exp_visit = t_ffn / (e * c)
    exp_flops = 2.0 * mats * d * f          # per visit
    # Per-call bytes: every expert's weights read once (amortized over its
    # c bucket rows) plus the per-row activations; f32 as measured.
    exp_bytes_call = (mats * d * f * e
                      + (2 * d + (mats - 1) * f) * e * c) * 4.0
    exp_bytes_visit = exp_bytes_call / (e * c)

    # -- gateway: flash-decode attention swept over batch sizes ----------
    hkv, g_rep, hd = w.n_kv_heads, w.n_heads // w.n_kv_heads, w.head_dim
    s = ctx_len
    attn_by_batch: dict[str, float] = {}
    attn_energy: dict[str, dict] = {}
    for b in batches:
        q = normal(b, hkv, g_rep, hd)
        kv = normal(b, hkv, s, hd)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
        attn_by_batch[str(b)] = timed_call(attn_fn, q, kv, kv, pos,
                                           iters=iters)
        q_bytes = q.numel() * q.element_size()
        kv_bytes = kv.numel() * kv.element_size()
        attn_energy[str(b)] = {
            "flops": 4.0 * b * w.n_heads * hd * s,
            "bytes": float(q_bytes + 2 * kv_bytes + q_bytes),
        }

    # -- head: the unembedding matmul ------------------------------------
    hb = 8
    xh = normal(hb, d)
    wh = normal(d, w.vocab_size)
    with _exact_f32():
        t_head = timed_call(torch.matmul, xh, wh, iters=iters)
    head_tok = t_head / hb

    return {
        "host": host_probe(device=dev),
        "measured_s": {
            "expert_visit": float(exp_visit),
            "gateway_by_batch": attn_by_batch,
            "head_token": float(head_tok),
        },
        "kernel_energy": {
            "expert_visit": {"flops": float(exp_flops),
                             "bytes": float(exp_bytes_visit)},
            "gateway_by_batch": attn_energy,
            "head_token": {
                "flops": 2.0 * d * w.vocab_size,
                "bytes": float((d * w.vocab_size + w.vocab_size + d) * 4.0),
            },
        },
        "impl": impl,
        "iters": int(iters),
    }


# --------------------------------------------------------------------- #
# Derivation: measured / roofline crossing -> satellite-unit table
# --------------------------------------------------------------------- #


def _sat_rates(compute: ComputeConfig, sat_bw: float | None) -> dict:
    """Satellite (flops_per_s, bw) the derived times target."""
    f = compute.flops_per_s
    return {"flops_per_s": float(f),
            "bw_bytes_per_s": float(sat_bw if sat_bw is not None
                                    else f * SAT_BYTES_PER_FLOP)}


def _efficiencies(measured: dict) -> dict:
    """Per-component achieved fraction of the host roofline ideal."""
    host = tuple(measured["host"])
    ms, ke = measured["measured_s"], measured["kernel_energy"]

    def eff(flops, nbytes, t):
        ideal = _ideal_host(flops, nbytes, host)
        return float(np.clip(ideal / max(t, 1e-12), MIN_EFFICIENCY, 1.0))

    e_exp = eff(ke["expert_visit"]["flops"], ke["expert_visit"]["bytes"],
                ms["expert_visit"])
    gw = [eff(ke["gateway_by_batch"][b]["flops"],
              ke["gateway_by_batch"][b]["bytes"],
              ms["gateway_by_batch"][b])
          for b in sorted(ms["gateway_by_batch"], key=int)]
    e_head = eff(ke["head_token"]["flops"], ke["head_token"]["bytes"],
                 ms["head_token"])
    return {"expert": e_exp, "gateway": float(np.median(gw)),
            "head": e_head}


def _step_seconds(flops: float, nbytes: float, rates: dict,
                  eff: float) -> float:
    """Roofline max-rule time at ``rates``, degraded by efficiency."""
    ideal = max(flops / rates["flops_per_s"],
                nbytes / rates["bw_bytes_per_s"])
    return ideal / eff


def derive_table(name: str, workload: MoEWorkload, measured: dict,
                 ctx_len: int, batches: tuple[int, ...],
                 compute: ComputeConfig, sat_bw: float | None = None,
                 jax_version: str | None = None,
                 backend: str | None = None) -> ServiceTable:
    """Deterministically derive a :class:`ServiceTable` from measurements.

    Pure given ``measured`` (the :func:`measure_components` output) and
    the reference's derivation step for step, so the same inputs give the
    reference's table and hash.  ``jax_version`` defaults to the torch
    version, ``backend`` to ``"cuda"`` for ``impl="cuda"`` measurements
    and ``"cpu"`` otherwise.
    """
    w = workload
    sat = _sat_rates(compute, sat_bw)
    eff = _efficiencies(measured)

    energy = {
        "gateway": {"flops_per_token": w.gateway_flops(ctx_len),
                    "weight_bytes": w.gateway_weight_bytes,
                    "token_bytes": w.gateway_token_bytes(ctx_len)},
        "expert": {"flops": w.expert_flops, "bytes": w.expert_bytes},
        "head": {"flops": w.lm_head_flops, "bytes": w.lm_head_bytes},
    }
    exp_s = _step_seconds(w.expert_flops, w.expert_bytes, sat,
                          eff["expert"])
    gw_by_batch = {
        str(b): _step_seconds(
            b * w.gateway_flops(ctx_len),
            w.gateway_weight_bytes + b * w.gateway_token_bytes(ctx_len),
            sat, eff["gateway"])
        for b in batches
    }
    head_s = _step_seconds(w.lm_head_flops, w.lm_head_bytes, sat,
                           eff["head"])
    impl = measured.get("impl", "ref")
    if backend is None:
        backend = "cuda" if impl == "cuda" else "cpu"

    table = ServiceTable(
        version=TABLE_VERSION,
        name=name,
        jax_version=jax_version if jax_version is not None
        else torch.__version__,
        backend=backend,
        impl=impl,
        ctx_len=int(ctx_len),
        batches=tuple(int(b) for b in batches),
        workload=dataclasses.asdict(w),
        host={"flops_per_s": float(measured["host"][0]),
              "bw_bytes_per_s": float(measured["host"][1])},
        sat=sat,
        energy=energy,
        measured_s=measured["measured_s"],
        efficiency=eff,
        derived={"expert_s": [float(exp_s)] * w.n_experts,
                 "gateway_s_by_batch": gw_by_batch,
                 "head_s": float(head_s)},
        meta={"iters": measured.get("iters", 0),
              "kernel_energy": measured["kernel_energy"]},
    )
    return dataclasses.replace(table, table_hash=table.compute_hash())


def calibrate(name: str, workload: MoEWorkload, ctx_len: int = 1024,
              batches: tuple[int, ...] = DEFAULT_BATCHES,
              compute: ComputeConfig | None = None,
              sat_bw: float | None = None, impl: str | None = None,
              iters: int = 3, measured: dict | None = None,
              device="cuda") -> ServiceTable:
    """Measure the port's kernels on ``device`` and derive a calibrated
    service table.

    ``impl=None`` picks ``"cuda"`` (the kernels) when ``device`` is a
    CUDA device and ``"ref"`` (the plain versions) otherwise; the table's
    ``backend`` is the type of the device measured on.  ``measured`` may
    be injected (the :func:`measure_components` output) to skip
    re-timing — the path the determinism tests use; ``device`` and
    ``impl`` are then unused and :func:`derive_table` takes ``backend``
    from the measurement's ``impl``.
    """
    if compute is None:
        compute = ComputeConfig()
    backend = None
    if measured is None:
        from .. import resolve_device
        dev = resolve_device(device)
        backend = dev.type
        if impl is None:
            impl = "cuda" if backend == "cuda" else "ref"
        measured = measure_components(workload, ctx_len, batches, impl,
                                      iters=iters, device=dev)
    return derive_table(name, workload, measured, ctx_len, batches,
                        compute, sat_bw=sat_bw, backend=backend)


def verify_table(table: ServiceTable,
                 compute: ComputeConfig | None = None) -> bool:
    """Re-derive the table from its own stored measurements and compare.

    True iff the derivation is reproducible (the roofline-determinism
    check): identical efficiency and derived service times, matching
    content hash.  A satellite-rate mismatch (different ``compute``) also
    returns False.
    """
    if compute is None:
        compute = ComputeConfig()
    measured = {
        "host": (table.host["flops_per_s"], table.host["bw_bytes_per_s"]),
        "measured_s": table.measured_s,
        "kernel_energy": table.meta.get("kernel_energy", {}),
        "impl": table.impl,
        "iters": table.meta.get("iters", 0),
    }
    if not measured["kernel_energy"]:
        return False
    redo = derive_table(table.name, table.workload_obj(), measured,
                        table.ctx_len, table.batches, compute,
                        sat_bw=table.sat["bw_bytes_per_s"],
                        jax_version=table.jax_version,
                        backend=table.backend)
    same_eff = all(np.isclose(redo.efficiency[k], table.efficiency[k],
                              rtol=1e-12) for k in table.efficiency)
    same_exp = np.allclose(redo.derived["expert_s"],
                           table.derived["expert_s"], rtol=1e-12)
    same_gw = all(np.isclose(redo.derived["gateway_s_by_batch"][b],
                             table.derived["gateway_s_by_batch"][b],
                             rtol=1e-12)
                  for b in table.derived["gateway_s_by_batch"])
    same_head = np.isclose(redo.derived["head_s"], table.derived["head_s"],
                           rtol=1e-12)
    return bool(same_eff and same_exp and same_gw and same_head
                and redo.compute_hash() == table.compute_hash())


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
    """Load a committed table by name (version and content hash checked),
    registering it for :func:`provenance`."""
    path = table_path(name, table_dir)
    if not path.exists():
        raise FileNotFoundError(
            f"no calibration table {name!r} at {path} — generate one with "
            "calibrate() and save_table()")
    table = ServiceTable.from_dict(json.loads(path.read_text()))
    _LOADED_TABLES[table.name] = table.table_hash or table.compute_hash()
    return table


def list_tables(table_dir: Path | str | None = None) -> list[str]:
    """Names of every committed table."""
    base = Path(table_dir) if table_dir is not None else TABLE_DIR
    if not base.exists():
        return []
    return sorted(p.stem for p in base.glob("*.json"))


def provenance() -> dict:
    """Resolved service-model provenance for benchmark JSON.

    The reference's keys: the framework version (torch's, under
    ``"jax"``) and the device type this process would measure on, the
    table schema version, and the content hash of every table loaded so
    far.
    """
    return {
        "jax": torch.__version__,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "table_version": TABLE_VERSION,
        "tables": dict(_LOADED_TABLES),
    }


def attach_dryrun(table: ServiceTable, record: dict) -> ServiceTable:
    """Fold a dry-run cell record into the table's metadata.

    Stores the compiled cell's roofline terms (per-chip FLOPs/bytes and
    the bound time) as a cross-check of the analytic energy accounting;
    the content hash is recomputed.  Returns the updated table.
    """
    roof = record.get("roofline", {})
    meta = dict(table.meta)
    meta["dryrun"] = {
        "cell": f"{record.get('arch')}__{record.get('shape')}"
                f"__{record.get('mesh')}",
        "flops_per_chip": roof.get("flops_per_chip"),
        "bytes_per_chip": roof.get("bytes_per_chip"),
        "compute_s": roof.get("compute_s"),
        "memory_s": roof.get("memory_s"),
        "bound_time_s": max(roof.get("compute_s", 0.0) or 0.0,
                            roof.get("memory_s", 0.0) or 0.0),
    }
    out = dataclasses.replace(table, meta=meta)
    return dataclasses.replace(out, table_hash=out.compute_hash())


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
