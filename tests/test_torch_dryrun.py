"""``launch.op_analysis`` and ``launch.dryrun``: the port's dry run.

(a) A smoke step (train, prefill, decode) of deepseek-moe-16b, qwen2.5-3b
    and xlstm-350m counts the same flops, bytes, ops and kernel calls on
    ``meta`` tensors as on the CPU, where the kernels run their plain
    versions: each kernel call counted once (gmm three times a MoE block
    a pass, decode_attention once an attention block a decode step) and
    none of its plain version's ops.
(b) The multiplied count (loops over time and attention chunks run one
    iteration of each kind; the depth extended from one and two units)
    equals the full count exactly, forward and backward with unit remat:
    the counterpart of ``test_walker_scales_with_depth_xla_does_not``.
(c) ``planned`` bytes per rank equal the bytes the reference's
    ``ShardingRules`` specs imply for its ``input_specs`` structs, for
    every arch and shape on both production meshes (fake meshes, no
    process group), and ``held``, the bytes of rank 0's blocks
    (``input_specs`` with ``par``), equals ``planned`` input by input,
    ``long_500k``'s sequence-split KV cache included; and so under
    ZeRO-1 (``zero_opt``) for the ``train_4k`` cells.
(d) The CLI writes a skip record and ``ok`` records in a subprocess (the
    fake process group is process-wide), and their table.
(e) ``calibrate_hook`` folds a record into a copy of a committed table.
(f) The kernel wrappers' ``meta`` branch: an empty result of the right
    shape and dtype, no launch.

Counts are integers and compared exactly.  The recurrent cases take
S = 8 or 6, the attention cases S = 64 (four chunks of the smoke
configs' 16), so that every loop runs more than the three iterations a
multiplied count keeps.  None of it initialises CUDA (the ``meta``
counts run with ``torch.cuda``'s initialisation made to raise).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as jcfgs
import repro.distributed.sharding as jsharding
import repro.launch.steps as jsteps

from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch import counting
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.kernels import decode_attn, moe_gmm, ops
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.roofline import block_specs
from repro_torch.launch.steps import input_specs
from repro_torch.models import Parallel, init_cache, init_params, random_batch
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
SMOKE = {"deepseek-moe-16b": 64, "qwen2.5-3b": 64, "xlstm-350m": 8}
KINDS = ("train", "prefill", "decode")


def _cfg(arch: str):
    """The smoke config with decode attention through the kernel on the
    CPU too (the card's path, which ``meta`` takes)."""
    return dataclasses.replace(smoke_config(arch), use_pallas_decode=True)


def _cpu_specs(cfg, shape: ShapeSpec) -> dict:
    """``input_specs``' layout on the CPU, with values."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         cast=False)
    batch = random_batch(cfg, shape.global_batch, shape.seq_len, seed=1,
                         device="cpu")
    if shape.kind == "train":
        return {"params": params, "opt_state": adamw_init(params),
                "batch": batch}
    if shape.kind == "prefill":
        batch.pop("labels")
        return {"params": params, "batch": batch}
    b = shape.global_batch
    return {"params": params, "cache": init_cache(cfg, b, shape.seq_len, "cpu"),
            "tokens": torch.zeros((b, 1), dtype=torch.int32),
            "pos": torch.full((b,), shape.seq_len - 1, dtype=torch.int32)}


def _count(cfg, shape, specs, multiply=False) -> op_analysis.OpCost:
    step, args = dryrun.step_call(cfg, shape, Parallel(), specs)
    cost, _ = op_analysis.analyze(step, *args, multiply=multiply)
    return cost


def _no_cuda():
    raise AssertionError("CUDA initialised")


def _same(a: op_analysis.OpCost, b: op_analysis.OpCost) -> None:
    assert a.flops == b.flops
    assert a.bytes_accessed == b.bytes_accessed
    assert a.kernel_counts == b.kernel_counts
    assert a.op_counts == b.op_counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_meta_counts_what_the_cpu_counts(arch, kind, monkeypatch):
    cfg = _cfg(arch)
    shape = ShapeSpec("smoke", SMOKE[arch], 2, kind)
    ops.reset_launch_counts()
    with monkeypatch.context() as m:       # meta touches no CUDA
        m.setattr(torch.cuda, "_lazy_init", _no_cuda)
        on_meta = _count(cfg, shape, input_specs(cfg, shape))
    on_cpu = _count(cfg, shape, _cpu_specs(cfg, shape))
    _same(on_meta, on_cpu)
    assert on_meta.flops > 0 and on_meta.bytes_accessed > 0
    specs = block_specs(cfg)
    n_moe = sum(s.ffn == "moe" for s in specs)
    n_attn = sum(s.mixer == "attn" for s in specs)
    # a train step: forward, remat's second forward, and dx, dw of each
    passes = {"train": 2 * 3 + 2 * 3, "prefill": 3, "decode": 3}[kind]
    want = {}
    if n_moe:
        want["gmm"] = n_moe * passes
    if kind == "decode" and n_attn:
        want["decode_attention"] = n_attn
    assert on_meta.kernel_counts == want
    assert ops.launch_counts()["gmm"] == 0
    assert ops.launch_counts()["decode_attention"] == 0


MULTIPLIED = [("deepseek-moe-16b", "train", 64, 4),
              ("qwen2.5-3b", "prefill", 64, 4),
              ("xlstm-350m", "train", 6, 3),
              ("jamba-1.5-large-398b", "train", 6, 3),
              ("jamba-1.5-large-398b", "decode", 8, 4)]


@pytest.mark.parametrize("arch,kind,seq,units", MULTIPLIED)
def test_multiplied_count_equals_the_full_count(arch, kind, seq, units):
    cfg = dryrun.with_units(_cfg(arch), units)
    shape = ShapeSpec("smoke", seq, 2, kind)
    full = _count(cfg, shape, input_specs(cfg, shape), multiply=False)
    multiplied = dryrun.count_step(cfg, shape, Parallel(), 1)
    _same(multiplied, full)
    assert multiplied.loop_multiplied and not full.loop_multiplied


def test_steps_and_pad():
    assert list(counting.steps(5)) == [0, 1, 2, 3, 4]     # no count
    seen = []

    def body():
        for t in counting.steps(6):
            seen.append(t)
            torch.ones(3, device="meta").add_(1)
        return counting.pad([torch.ones(1, device="meta")], 4)
    cost, out = op_analysis.analyze(body, multiply=True)
    assert seen == [0, 1, 5]
    assert len(out) == 4
    assert cost.op_counts == {"aten.ones": 7, "aten.add_": 6}
    assert cost.bytes_accessed == 6 * 12 + 6 * 24 + 4
    seen.clear()
    cost, out = op_analysis.analyze(body)        # the default runs them all
    assert seen == list(range(6)) and len(out) == 4
    assert cost.op_counts == {"aten.ones": 7, "aten.add_": 6}


def test_op_bytes_rules():
    """Views count nothing, gathers twice their result, scatters twice
    their update, copies read only their source."""
    def body(x, idx, big):
        x.t()
        big[idx]
        big.index_put_((idx,), torch.ones(2, 4))
        torch.empty(5)
        x.clone()
        big[:2].copy_(x[:2])
    x, big = torch.ones(4, 4), torch.zeros(100, 4)
    idx = torch.tensor([1, 2])
    cost, _ = op_analysis.analyze(body, x, idx, big)
    # index 2 x 32, ones 32, index_put_ 2 x 32, clone 64 + 64, copy_ 32 + 32
    assert cost.bytes_accessed == 64 + 32 + 64 + 128 + 64


def _ref_mesh(shape):
    class FakeMesh:
        pass
    mesh = FakeMesh()
    mesh.shape = dict(shape)
    mesh.axis_names = tuple(shape)
    mesh.coordinate = lambda: {a: 0 for a in shape}     # rank 0
    return mesh


def _ref_planned(cfg, shape, mesh_shape, zero_opt: bool = False) -> dict:
    """Bytes per rank the reference's specs imply for its structs, by the
    inputs its ``lower_cell`` shards (pos replicated)."""
    import jax
    mesh = _ref_mesh(mesh_shape)
    daxes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    rules = jsharding.ShardingRules(cfg, mesh, data_axes=daxes,
                                    zero_opt=zero_opt)
    specs = jsteps.input_specs(cfg, shape)
    p_specs = rules.param_specs(specs["params"])
    trees = {"params": (specs["params"], p_specs)}
    if shape.kind == "train":
        trees["opt_state"] = (specs["opt_state"], rules.opt_state_specs(
            specs["opt_state"], p_specs))
    if "batch" in specs:
        trees["batch"] = (specs["batch"], rules.batch_spec(specs["batch"]))
    if "cache" in specs:
        trees["cache"] = (specs["cache"], rules.cache_specs(specs["cache"]))
        inputs = {k: specs[k] for k in ("tokens", "embeds")
                  if specs.get(k) is not None}
        inputs_specs = rules.batch_spec(inputs)
        inputs["pos"] = specs["pos"]
        inputs_specs["pos"] = jax.sharding.PartitionSpec()
        trees["inputs"] = (inputs, inputs_specs)
    out = {}
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    for name, (tree, spec_tree) in trees.items():
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(spec_tree, is_leaf=is_spec)
        assert len(leaves) == len(spec_leaves)
        total = 0
        for leaf, spec in zip(leaves, spec_leaves):
            split = 1
            for entry in spec:
                for axis in (entry if isinstance(entry, tuple) else (entry,)):
                    if axis is not None:
                        split *= mesh_shape[axis]
            total += leaf.size * leaf.dtype.itemsize // split
        out[name] = total
    out["total"] = sum(out.values())
    return out


MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


@pytest.mark.parametrize("arch", list_archs())
def test_planned_bytes_are_the_references(arch):
    cfg, jcfg = get_config(arch), jcfgs.get_config(arch)
    for name, shape in SHAPES.items():
        if not jcfgs.shape_applies(jcfg, jcfgs.SHAPES[name])[0]:
            continue
        specs = input_specs(cfg, shape)
        for mesh_shape in MESHES:
            mesh = _ref_mesh(mesh_shape)
            daxes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
            rules = ShardingRules(cfg, mesh, data_axes=daxes)
            given = input_specs(cfg, shape, dryrun.parallel(mesh, shape))
            mem = dryrun.memory_per_rank(rules, specs, mesh_shape, given)
            want = _ref_planned(jcfg, jcfgs.SHAPES[name], mesh_shape)
            assert mem["planned"] == want, (name, mesh_shape)
            held, planned = mem["held"], mem["planned"]
            # long_500k's batch-1 KV cache too: its sequence split over
            # the data axes (context parallelism)
            for k in planned:
                assert held[k] == planned[k], (name, mesh_shape, k)
            assert mem["fits"] == (held["total"] <= 80 * 2**30)


@pytest.mark.parametrize("arch", [
    a for a in list_archs()
    if jcfgs.shape_applies(jcfgs.get_config(a), jcfgs.SHAPES["train_4k"])[0]])
def test_zero1_planned_bytes_are_the_references(arch):
    """Under ZeRO-1 (the dry run's ``zero1`` override) the ``train_4k``
    cells plan the reference's bytes (each moment further split over the
    data axes), and rank 0 is given its moment slices: ``held`` equals
    ``planned``, the optimizer state smaller than without ZeRO."""
    cfg, jcfg = get_config(arch), jcfgs.get_config(arch)
    shape = SHAPES["train_4k"]
    specs = input_specs(cfg, shape)
    for mesh_shape in MESHES:
        mesh = _ref_mesh(mesh_shape)
        par = dryrun.parallel(mesh, shape, zero_opt=True)
        mem = dryrun.memory_per_rank(par.rules(cfg), specs, mesh_shape,
                                     input_specs(cfg, shape, par))
        want = _ref_planned(jcfg, jcfgs.SHAPES["train_4k"], mesh_shape,
                            zero_opt=True)
        assert mem["planned"] == want, mesh_shape
        assert mem["held"] == mem["planned"], mesh_shape
        plain = _ref_planned(jcfg, jcfgs.SHAPES["train_4k"], mesh_shape)
        assert want["opt_state"] < plain["opt_state"] / 8, mesh_shape


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_held_is_planned(shape_name):
    """Rank 0 of the pod mesh is given its blocks (``input_specs`` with
    ``par``): the params by the rules (deepseek's 64 experts a sixteenth,
    its heads a sixteenth), the optimizer state alike, the batch or the
    cache its sixteenth of the rows (and of the KV heads: 16 divide the
    model axis), so ``held`` is ``planned``, input by input, and fits the
    card; the whole model is not held."""
    from repro_torch.tree import tree_leaves
    cfg = get_config("deepseek-moe-16b")
    shape = SHAPES[shape_name]
    mesh_shape = MESHES[0]
    mesh = _ref_mesh(mesh_shape)
    rules = ShardingRules(cfg, mesh)
    par = dryrun.parallel(mesh, shape)
    given = input_specs(cfg, shape, par)
    mem = dryrun.memory_per_rank(rules, input_specs(cfg, shape), mesh_shape,
                                 given)
    held, planned = mem["held"], mem["planned"]
    assert held == planned
    assert held["params"] < 5 * 2**30               # 61 GiB of f32 whole
    assert mem["fits"]
    ffn = given["params"]["layers"][0]["ffn"]
    assert ffn["w_gate"].shape == (64 // 16, 2048, 1408)
    assert given["params"]["layers"][0]["mixer"]["w_q"].shape == (2048, 128)
    if shape.kind == "train":
        assert given["batch"]["tokens"].shape == (256 // 16, 4096)
        assert len(tree_leaves(given["opt_state"]["mu"])) \
            == len(tree_leaves(given["params"]))
    else:
        assert given["cache"]["layers"][0]["k"].shape == (128 // 16, 32768,
                                                          1, 128)
        assert given["tokens"].shape == (8, 1) and given["pos"].shape == (128,)


def test_cli_writes_skip_and_ok_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-moe-16b", "--mesh", "pod", "--set", "n_layers=2",
         "--tag", "two", "--table", "--out", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    records = {p.stem: json.loads(p.read_text())
               for p in tmp_path.glob("*.json")}
    assert set(records) == {f"deepseek-moe-16b__{s}__pod_16x16__two"
                            for s in SHAPES}
    skip = records["deepseek-moe-16b__long_500k__pod_16x16__two"]
    assert skip["status"] == "skip" and skip["reason"].startswith("SKIP(")
    ok = records["deepseek-moe-16b__decode_32k__pod_16x16__two"]
    assert ok["status"] == "ok" and ok["n_devices"] == 256
    assert ok["overrides"] == {"n_layers": 2} and ok["tag"] == "two"
    assert {"op_cost", "roofline", "memory", "trace_s"} <= set(ok)
    assert ok["op_cost"]["kernel_counts"]["gmm"] == 3
    assert ok["op_cost"]["kernel_counts"]["decode_attention"] == 2
    # ep_rep decode, each summed over the model axis: the embedding, two
    # attention outputs, the dense FFN, the MoE body's combine and its
    # shared experts
    assert ok["op_cost"]["collective_counts"]["all-reduce"] == 6
    roof = ok["roofline"]
    assert roof["n_devices"] == 256 and roof["flops_per_chip"] > 0
    assert 0 < roof["useful_flops_ratio"] < 1
    assert ok["memory"]["held"] == ok["memory"]["planned"]
    assert "[OK] deepseek-moe-16b__train_4k" in res.stdout
    assert res.stdout.strip().endswith("done; 0 failures")
    rows = [line for line in res.stdout.splitlines() if line.startswith("|")]
    assert len(rows) == 2 + 3           # header, rule, the three ok shapes
    assert rows[-1].startswith("| deepseek-moe-16b | decode_32k | ")
    assert rows[-1].endswith(" / - |")     # pod only


def test_calibrate_hook_on_a_copy(tmp_path):
    from repro_torch.core import calibration as cal
    shutil.copy(cal.table_path("deepseek-moe-16b"), tmp_path)
    before = cal.load_table("deepseek-moe-16b", tmp_path)
    committed = cal.table_path("deepseek-moe-16b").read_bytes()
    record = {"status": "ok", "arch": "deepseek-moe-16b",
              "shape": "decode_32k", "mesh": "pod_16x16",
              "roofline": {"flops_per_chip": 1.2e12, "bytes_per_chip": 9e11,
                           "compute_s": 1.2e12 / 989e12,
                           "memory_s": 9e11 / 3.35e12}}
    dryrun.calibrate_hook(record, table_dir=tmp_path)
    after = cal.load_table("deepseek-moe-16b", tmp_path)
    assert after.meta["dryrun"]["cell"] == "deepseek-moe-16b__decode_32k__pod_16x16"
    assert after.meta["dryrun"]["bound_time_s"] == 9e11 / 3.35e12
    assert after.table_hash != before.table_hash
    assert after.table_hash == after.compute_hash()
    assert cal.table_path("deepseek-moe-16b").read_bytes() == committed
    dryrun.calibrate_hook({"status": "skip", "arch": "deepseek-moe-16b"},
                          table_dir=tmp_path)
    dryrun.calibrate_hook(dict(record, arch="qwen2.5-3b"), table_dir=tmp_path)
    assert not (tmp_path / "qwen2.5-3b.json").exists()


def test_wrappers_on_meta_launch_nothing():
    ops.reset_launch_counts()
    x = torch.empty((4, 3, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((4, 16, 8), dtype=torch.bfloat16, device="meta")
    out = moe_gmm.gmm(x, w)
    assert out.device.type == "meta" and out.shape == (4, 3, 8)
    assert out.dtype == torch.bfloat16
    q = torch.empty((2, 4, 3, 64), device="meta")
    k = torch.empty((2, 4, 33, 64), device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    att = decode_attn.decode_attention(q, k, k, pos)
    assert att.device.type == "meta" and att.shape == q.shape
    assert ops.launch_counts()["gmm"] == 0
    assert ops.launch_counts()["decode_attention"] == 0
    with pytest.raises(ValueError):
        moe_gmm.gmm(x, w.transpose(1, 2))
    with pytest.raises(TypeError):
        decode_attn.decode_attention(q, k, k, pos.long())
    cost, _ = op_analysis.analyze(moe_gmm.gmm, x, w)
    assert cost.kernel_counts == {"gmm": 1} and cost.op_counts == {}
    assert cost.flops == 2 * 4 * 3 * 16 * 8
    assert cost.bytes_accessed == (4 * 3 * 16 + 4 * 16 * 8 + 4 * 3 * 8) * 2
    cost, _ = op_analysis.analyze(decode_attn.decode_attention, q, k, k, pos)
    assert cost.kernel_counts == {"decode_attention": 1}
    assert cost.flops == 4 * 4 * 3 * 64 * 2 * 33
    assert cost.bytes_accessed == 2 * q.numel() * 4 + 2 * 4 * 66 * 64 * 4 + 8
