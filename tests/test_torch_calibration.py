"""Calibration's measuring side in the port against the reference, on the CPU.

``derive_table``, ``verify_table`` and ``attach_dryrun`` are host numpy
in both packages: the same inputs give the same table and content hash.
``measure_components(impl="ref")`` times the port's plain versions here
(the CUDA kernels are timed on the card: ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py``); its energy accounting is the reference's exactly.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.core import calibration as rcal
from repro.core.latency import ComputeConfig as RCompute
from repro.core.workload import MoEWorkload as RWorkload
from repro_torch.core import calibration as pcal
from repro_torch.core.latency import ComputeConfig as PCompute
from repro_torch.core.workload import MoEWorkload as PWorkload

TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff_expert=128, n_experts=4, top_k=2, vocab_size=512)
TINY_CTX = 32
TINY_BATCHES = (1, 2, 4)


@pytest.fixture(scope="module")
def measured():
    return pcal.measure_components(PWorkload(**TINY), TINY_CTX, TINY_BATCHES,
                                   "ref", iters=1, rows_per_expert=1,
                                   device="cpu")


def _both(measured, **kw):
    args = ("tiny", TINY_CTX, TINY_BATCHES)
    r = rcal.derive_table(args[0], RWorkload(**TINY), measured, *args[1:],
                          RCompute(), jax_version="2.9.0", backend="cpu", **kw)
    p = pcal.derive_table(args[0], PWorkload(**TINY), measured, *args[1:],
                          PCompute(), jax_version="2.9.0", backend="cpu", **kw)
    return r, p


@pytest.mark.parametrize("sat_bw", [None, 1e8])
def test_derive_table_is_the_references(measured, sat_bw):
    r, p = _both(measured, sat_bw=sat_bw)
    assert p.to_dict() == r.to_dict()
    assert p.table_hash == r.table_hash == p.compute_hash()


def test_derive_table_from_a_committed_tables_measurements():
    """The committed deepseek table's own measurements, re-derived by the
    port, give the committed hash."""
    t = pcal.load_table("deepseek-moe-16b")
    m = {"host": (t.host["flops_per_s"], t.host["bw_bytes_per_s"]),
         "measured_s": t.measured_s, "kernel_energy": t.meta["kernel_energy"],
         "impl": t.impl, "iters": t.meta["iters"]}
    redo = pcal.derive_table(t.name, t.workload_obj(), m, t.ctx_len,
                             t.batches, PCompute(), jax_version=t.jax_version,
                             backend=t.backend)
    assert redo.table_hash == t.table_hash == "16a95d631b31ab56"


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "llama-moe-3.5b"])
def test_committed_tables_verify_in_the_port(name):
    table = pcal.load_table(name)
    assert pcal.verify_table(table)
    assert pcal.verify_table(table, PCompute()) == \
        rcal.verify_table(rcal.load_table(name), RCompute())
    other = PCompute(peak_gflops=20.8)
    assert not pcal.verify_table(table, other)


def test_deepseek_table_copy_is_pinned_to_reference():
    name = "deepseek-moe-16b"
    assert pcal.load_table(name).table_hash == \
        rcal.load_table(name).table_hash == "16a95d631b31ab56"
    assert pcal.table_path(name).read_bytes() == \
        rcal.table_path(name).read_bytes()


def test_list_tables_is_the_references():
    assert pcal.list_tables() == rcal.list_tables() == \
        ["deepseek-moe-16b", "llama-moe-3.5b"]


def test_attach_dryrun_gives_the_references_hash(measured):
    r, p = _both(measured)
    record = {"arch": "deepseek-moe-16b", "shape": "decode_b4",
              "mesh": "1x1", "roofline": {"flops_per_chip": 3.5e12,
                                          "bytes_per_chip": 3.2e10,
                                          "compute_s": 0.0035,
                                          "memory_s": 0.0098}}
    rd, pd = rcal.attach_dryrun(r, record), pcal.attach_dryrun(p, record)
    assert pd.to_dict() == rd.to_dict()
    assert pd.table_hash == rd.table_hash != p.table_hash
    assert pd.meta["dryrun"]["bound_time_s"] == 0.0098
    empty_r = rcal.attach_dryrun(r, {})
    assert pcal.attach_dryrun(p, {}).table_hash == empty_r.table_hash


def test_measure_components_matches_the_references_accounting(measured):
    want = rcal.measure_components(RWorkload(**TINY), TINY_CTX, TINY_BATCHES,
                                   "ref", iters=1, rows_per_expert=1)
    assert set(measured) == set(want)
    assert measured["kernel_energy"] == want["kernel_energy"]
    assert set(measured["measured_s"]) == set(want["measured_s"])
    assert set(measured["measured_s"]["gateway_by_batch"]) == \
        set(want["measured_s"]["gateway_by_batch"])
    assert (measured["impl"], measured["iters"]) == ("ref", 1)
    ms = measured["measured_s"]
    times = [ms["expert_visit"], ms["head_token"],
             *ms["gateway_by_batch"].values()]
    assert all(np.isfinite(t) and t > 0 for t in times)
    assert len(measured["host"]) == 2 and min(measured["host"]) > 0


@pytest.mark.parametrize("device", [{"device": "cpu"}, {}],
                         ids=["cpu", "default-device"])
def test_calibrate_with_measurements_equals_derive_table(measured, device):
    """Injected measurements: the table is ``derive_table``'s, and its
    ``backend`` follows the measurement (``impl="ref"``: ``"cpu"``), not
    ``calibrate``'s default device."""
    got = pcal.calibrate("tiny", PWorkload(**TINY), TINY_CTX, TINY_BATCHES,
                         measured=measured, **device)
    want = pcal.derive_table("tiny", PWorkload(**TINY), measured, TINY_CTX,
                             TINY_BATCHES, PCompute(), backend="cpu")
    assert got.to_dict() == want.to_dict()
    assert (got.backend, got.impl) == ("cpu", "ref")
    import torch
    assert got.jax_version == torch.__version__
    assert pcal.verify_table(got)


def test_calibrate_measures_on_the_cpu():
    table = pcal.calibrate("tiny", PWorkload(**TINY), TINY_CTX, (1, 2),
                           iters=1, device="cpu")
    assert (table.impl, table.backend, table.batches) == ("ref", "cpu", (1, 2))
    assert pcal.verify_table(table)
    assert set(table.efficiency) == {"expert", "gateway", "head"}
    assert all(pcal.MIN_EFFICIENCY <= v <= 1.0
               for v in table.efficiency.values())


def test_measure_components_refuses_other_impls():
    wl = PWorkload(**TINY)
    with pytest.raises(ValueError, match="impl"):
        pcal.measure_components(wl, TINY_CTX, TINY_BATCHES, "pallas",
                                device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pcal.measure_components(wl, TINY_CTX, TINY_BATCHES, "cuda",
                                device="cpu")


def test_tables_round_trip_between_the_packages(measured, tmp_path):
    """A table the port writes loads in the reference and the other way
    round: the field names are shared."""
    r, p = _both(measured)
    pcal.save_table(dataclasses.replace(p, name="port"), tmp_path)
    rcal.save_table(dataclasses.replace(r, name="ref"), tmp_path)
    assert rcal.load_table("port", tmp_path).table_hash == \
        pcal.load_table("port", tmp_path).table_hash
    assert pcal.load_table("ref", tmp_path).to_dict() == \
        rcal.load_table("ref", tmp_path).to_dict()
    d = json.loads(pcal.table_path("port", tmp_path).read_text())
    d["measured_s"]["head_token"] *= 2.0
    pcal.table_path("port", tmp_path).write_text(json.dumps(d))
    with pytest.raises(ValueError, match="hash"):
        pcal.load_table("port", tmp_path)


def test_provenance_reports_loaded_tables():
    pcal.load_table("deepseek-moe-16b")
    prov = pcal.provenance()
    assert set(prov) == {"jax", "backend", "table_version", "tables"}
    assert prov["table_version"] == pcal.TABLE_VERSION
    assert prov["tables"]["deepseek-moe-16b"] == "16a95d631b31ab56"
    assert prov["backend"] in ("cpu", "cuda")


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "llama-moe-3.5b"])
def test_h100_tables_verify_and_stay_out_of_the_listing(name):
    """The tables ``calibrate(impl="cuda")`` derived on an H100 (committed
    from ``chip_smoke.py``'s calibration phase) load with their hash,
    re-derive exactly, describe the reference's workload, and do not
    change ``list_tables()``."""
    h100 = pcal.TABLE_DIR / "h100"
    table = pcal.load_table(name, h100)
    assert (table.impl, table.backend) == ("cuda", "cuda")
    assert pcal.verify_table(table) and rcal.verify_table(
        rcal.load_table(name, h100))
    cpu = pcal.load_table(name)
    assert (table.workload, table.ctx_len, table.batches) == \
        (cpu.workload, cpu.ctx_len, cpu.batches)
    assert set(table.meta) == set(cpu.meta)
    assert pcal.list_tables(h100) == pcal.list_tables() == \
        rcal.list_tables()
