"""``launch.roofline`` against the reference's ``repro.launch.roofline``.

``model_flops`` is config arithmetic and equals the reference's exactly
for every arch x shape.  ``derive`` keeps the reference's terms on the
H100's constants: each term times its constant is the reference's, and
with the reference's constants set to the H100's every field, the
dominant term and the ratios are equal.  ``collective_stats`` prices the
port's collective records as ``parse_collectives`` prices one synthetic
HLO line of each op (exactly).  The step bounds moved here from
``chip_smoke.py`` keep their values to 1e-12 relative (the byte totals
exactly).
"""
from __future__ import annotations

import dataclasses

import pytest

import repro.configs as jcfgs
import repro.launch.roofline as jroof

import repro_torch.configs as tcfgs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import roofline as troof

ARCH_SHAPES = [(a, s) for a in jcfgs.list_archs() for s in jcfgs.SHAPES]


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES)
def test_model_flops_equals_the_references(arch, shape):
    want = jroof.model_flops(jcfgs.get_config(arch), jcfgs.SHAPES[shape])
    got = troof.model_flops(tcfgs.get_config(arch), tcfgs.SHAPES[shape])
    assert got == want


def test_model_flops_cases_cover_every_arch_and_shape():
    assert len(ARCH_SHAPES) == 44
    assert set(tcfgs.list_archs()) == set(jcfgs.list_archs())


def test_h100_constants():
    """The data sheet's rates (module docstring of ``roofline``)."""
    assert troof.PEAK_FLOPS == 989e12
    assert troof.HBM_BW == 3.35e12
    assert troof.LINK_BW == 450e9
    assert troof.HBM_BYTES == 80 * 2**30


COSTS = [  # (flops, bytes, collective bytes): each term dominant once
    (4.0e15, 1.0e11, 1.0e9),
    (1.0e12, 7.0e12, 3.0e9),
    (1.0e9, 1.0e9, 5.0e11),
]


@pytest.mark.parametrize("flops,nbytes,coll", COSTS)
def test_derive_matches_the_reference(flops, nbytes, coll, monkeypatch):
    cost = {"flops": flops, "bytes accessed": nbytes}
    mf = 0.37 * flops * 256
    got = troof.derive(cost, troof.CollectiveStats({}, coll, coll), 256, mf)
    ref = jroof.derive(cost, jroof.CollectiveStats({}, coll, coll), 256, mf)
    assert got.compute_s * troof.PEAK_FLOPS == pytest.approx(
        ref.compute_s * jroof.PEAK_FLOPS, rel=1e-15)
    assert got.memory_s * troof.HBM_BW == pytest.approx(
        ref.memory_s * jroof.HBM_BW, rel=1e-15)
    assert got.collective_s * troof.LINK_BW == pytest.approx(
        ref.collective_s * jroof.ICI_BW, rel=1e-15)
    assert got.useful_flops_ratio == ref.useful_flops_ratio
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.LINK_BW)
    ref = jroof.derive(cost, jroof.CollectiveStats({}, coll, coll), 256, mf)
    assert got.asdict() == ref.asdict()
    assert got.dominant == ref.dominant
    assert got.bound_time_s == ref.bound_time_s


def test_derive_from_op_cost_reads_the_counts():
    from repro_torch.launch.op_analysis import OpCost
    cost = OpCost(flops=3 * 10**15, bytes_accessed=10**12,
                  collective_bytes=2.5e9)
    roof = troof.derive_from_op_cost(cost, 512, 1e17)
    assert roof.compute_s == 3e15 / troof.PEAK_FLOPS
    assert roof.memory_s == 1e12 / troof.HBM_BW
    assert roof.collective_s == 2.5e9 / troof.LINK_BW
    assert roof.dominant == "compute"
    assert roof.useful_flops_ratio == 1e17 / (3e15 * 512)


_HLO = {  # op -> (HLO line with result f32[rows,64], group written in)
    "all-gather": "%ag = f32[{r},64]{{1,0}} all-gather(f32[4,64]{{1,0}} %p), "
                  "channel_id=1, replica_groups={{{g}}}, dimensions={{0}}",
    "reduce-scatter": "%rs = f32[{r},64]{{1,0}} reduce-scatter(f32[64,64]{{1,0}}"
                      " %p), channel_id=2, replica_groups={{{g}}}, "
                      "dimensions={{0}}, to_apply=%add",
    "all-reduce": "%ar = f32[{r},64]{{1,0}} all-reduce(f32[{r},64]{{1,0}} %p), "
                  "channel_id=3, replica_groups={{{g}}}, to_apply=%add",
    "all-to-all": "%a2a = f32[{r},64]{{1,0}} all-to-all(f32[{r},64]{{1,0}} %p), "
                  "channel_id=4, replica_groups={{{g}}}, dimensions={{0}}",
    "collective-permute": "%cp = f32[{r},64]{{1,0}} collective-permute("
                          "f32[{r},64]{{1,0}} %p), channel_id=5, "
                          "source_target_pairs={{{{0,1}},{{1,0}}}}",
}


@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("op", sorted(_HLO))
def test_collective_stats_prices_as_parse_collectives(op, group):
    rows = 48
    members = "{" + ",".join(map(str, range(group))) + "}"
    line = _HLO[op].format(r=rows, g=members)
    want = jroof.parse_collectives(line, n_devices=16)
    # the reference prices a permute at R whatever the group
    size = group if op != "collective-permute" else None
    got = troof.collective_stats(
        [{"op": op, "result_bytes": rows * 64 * 4, "group_size": size}], 16)
    assert got.asdict() == want.asdict()
    assert got.counts == {op: 1}
    twice = troof.collective_stats(
        [{"op": op, "result_bytes": rows * 64 * 4, "group_size": size,
          "count": 2}], 16)
    assert twice.bytes_per_chip == 2 * want.bytes_per_chip
    assert twice.counts == {op: 2}


def test_ring_cost_refuses_an_unknown_op():
    with pytest.raises(ValueError):
        troof.ring_cost("broadcast", 100.0, 4)


# The totals chip_smoke.py's serve_weight_bytes gave at batch 4 before the
# move, and the decode-step bound they give at HBM_BW (ms).
SERVE_BYTES = {
    "llama-moe-3.5b": (13214154752, 3.9445),
    "deepseek-moe-16b": (32324714496, 9.6492),
    "xlstm-350m": (1364266272, 0.40724),
    "granite-moe-3b-a800m": (6593839104, 1.9683),
    "jamba-1.5-large-398b": (796687335424, 237.82),
}


@pytest.mark.parametrize("arch", sorted(SERVE_BYTES))
def test_serve_weight_bytes_keeps_its_values(arch):
    total, ms = SERVE_BYTES[arch]
    parts = troof.serve_weight_bytes(tcfgs.get_config(arch), 4)
    assert sum(parts.values()) == total
    got_ms = total / troof.HBM_BW * 1e3
    assert got_ms == pytest.approx(total / 3.35e12 * 1e3, rel=1e-12)
    assert got_ms == pytest.approx(ms, rel=2e-5)      # the digits stated


def test_serve_weight_bytes_scales_state_with_the_batch():
    cfg = tcfgs.get_config("xlstm-350m")
    one, four = (troof.serve_weight_bytes(cfg, b) for b in (1, 4))
    assert four["state"] == 4 * one["state"] > 0
    assert {k: v for k, v in four.items() if k != "state"} \
        == {k: v for k, v in one.items() if k != "state"}


def test_train_step_bound_keeps_its_values():
    """Granite at chip phase 15c's batch 4 x 2048 with its parameter
    count: 63.2262 TFLOP, 105.564 GB, 95.4412 ms (PERF.md)."""
    got = troof.train_step_bound(tcfgs.get_config("granite-moe-3b-a800m"),
                                 3_298_885_632, 4, 2048)
    want = {"gmm_gflop_layer": 309.237645312,
            "proj_gflop_layer": 103.079215104,
            "attn_gflop_layer": 51.564773376, "head_gflop": 1240.17180672,
            "forward_tflop": 16.116596342784, "step_tflop": 63.226213564416,
            "adamw_gb": 105.564340224, "ops_ms": 63.92943737554702,
            "bytes_ms": 31.511743350447762, "bound_ms": 95.44118072599478}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k


def test_block_specs_and_ffn_layers():
    ds = tcfgs.get_config("deepseek-moe-16b")
    assert len(troof.block_specs(ds)) == ds.n_layers
    assert troof.n_ffn_layers(ds) == (27, 0)
    jamba = tcfgs.get_config("jamba-1.5-large-398b")
    assert troof.n_ffn_layers(jamba) == (36, 36)
    smaller = dataclasses.replace(jamba, n_layers=16)
    assert troof.n_ffn_layers(smaller) == (8, 8)
    assert troof.mixer_bytes(ds, "attn", 4)[1] == 0


def test_model_flops_of_granites_train_shape():
    """The reference's yardstick at chip phase 15c's shape (48.3474
    TFLOP), three times ``train_step_bound``'s forward but for the
    causal pairs' diagonal and the non-matmul parameters."""
    cfg = tcfgs.get_config("granite-moe-3b-a800m")
    got = troof.model_flops(cfg, ShapeSpec("t", 2048, 4, "train"))
    assert got / 1e12 == pytest.approx(48.3474, abs=5e-5)
    fwd = troof.train_step_bound(cfg, 1, 4, 2048)["forward_tflop"]
    assert got / 1e12 == pytest.approx(3 * fwd, rel=2e-3)
