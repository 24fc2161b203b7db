"""Multi-pod dry run: count rank 0's step of every (arch x shape x mesh)
cell (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads the compiled artifact.  The port has no compiler to
ask, so it runs instead: inside a fake process group of 256 ranks (the
16 x 16 pod) or 512 (the 2 x 16 x 16 multi-pod), which answers every
collective without moving data, it builds the production mesh,
``Parallel``, ``ShardingRules`` and ``input_specs`` on the ``meta``
device and runs rank 0's train, prefill or serve step under
``op_analysis.analyze``.  Nothing is allocated and nothing touches
CUDA, whether or not a card is present.  The step is traced at one and
two pattern units and extended to the model's depth
(``op_analysis.by_units``); loops over time and over attention chunks
run one iteration of each kind (``counting.steps``).

The step is given rank 0's blocks of its inputs (``input_specs`` with
``par``: the params and optimizer state by ``ShardingRules``, ZeRO-1's
moment slices under ``--set zero1=true``, the batch and tokens by the
batch spec, the cache by ``cache_specs``, a batch-1 cache's sequence
split over the data axes) and computes rank 0's part (``long_500k``'s
decode combines the ranks' attention partials).  Each cell's record
gives rank 0's flops, bytes and collective bytes, the roofline terms on
the H100's rates (``roofline``), and its memory: ``planned`` is what
each rank would hold under ``ShardingRules``' specs, ``held`` the bytes
of the tensors the step is given (equal to ``planned``), and ``fits``
whether ``held`` fits the card.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-moe-16b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both

Results are cached as JSON under experiments/dryrun/ (one file per cell);
--force counts again.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ASSIGNED, REGISTRY, SHAPES, get_config, shape_applies
from ..distributed.sharding import PartitionSpec as P
from ..distributed.sharding import ShardingRules
from ..models import Parallel
from ..models.model import n_scan_units
from . import op_analysis
from . import roofline as rl
from .mesh import data_axes, make_production_mesh
from .steps import (input_specs, make_prefill_step, make_serve_step,
                    make_train_step)

OUT_DIR_DEFAULT = "experiments/dryrun"


def _parse_overrides(pairs) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            out[k] = True
        elif v in ("false", "False"):
            out[k] = False
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0,
    unless one of that size is up (a fake one of another size is
    replaced).  The fake group comes from ``torch.testing._internal``,
    torch's test utilities, not a public API: this is the one place the
    port imports it."""
    if dist.is_initialized():
        if dist.get_world_size() == world or dist.get_backend() != "fake":
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def step_call(cfg, shape, par: Parallel, specs: dict, micro: int = 1):
    """(step, args): one train, prefill or serve step of ``shape.kind``
    on the inputs ``specs`` (``input_specs``' layout)."""
    if shape.kind == "train":
        step = make_train_step(cfg, par, micro_batches=micro)
        return step, (specs["params"], specs["opt_state"], specs["batch"])
    if shape.kind == "prefill":
        return make_prefill_step(cfg, par, max_len=shape.seq_len), \
            (specs["params"], specs["batch"])
    return make_serve_step(cfg, par), \
        (specs["params"], specs["cache"], specs["tokens"], specs["pos"],
         specs.get("embeds"))


def with_units(cfg, units: int):
    """``cfg`` with ``units`` pattern units after the dense first block."""
    first = 1 if cfg.first_layer_dense else 0
    return dataclasses.replace(cfg, n_layers=(units + first) * len(cfg.pattern))


def parallel(mesh, shape, zero_opt: bool = False) -> Parallel:
    """``Parallel`` on ``mesh`` for a step of ``shape``, as the rules
    shard its inputs: the batch split over the data axes where it
    divides them, else the cache's sequence where its length does
    (context parallelism); ZeRO-1 with ``zero_opt``."""
    daxes = data_axes(mesh)
    n_data = 1
    for a in daxes:
        n_data *= mesh.shape[a]
    split = shape.global_batch % n_data == 0
    return Parallel(mesh=mesh, data_axes=daxes, batch_split=split,
                    context=not split and shape.seq_len % n_data == 0,
                    zero_opt=zero_opt)


def count_step(cfg, shape, par: Parallel, n_devices: int, micro: int = 1,
               multiply: bool = True) -> op_analysis.OpCost:
    """Rank 0's ``OpCost`` for one step of ``cfg`` at ``shape`` on meta
    inputs (its blocks): with ``multiply``, traced at one and two units
    and extended to the depth (``op_analysis.by_units``), loops
    multiplied."""
    def count(c):
        step, args = step_call(c, shape, par, input_specs(c, shape, par),
                               micro)
        cost, _ = op_analysis.analyze(step, *args, n_devices=n_devices,
                                      multiply=multiply)
        return cost
    units = n_scan_units(cfg)
    if not multiply or units <= 2:
        return count(cfg)
    return op_analysis.by_units(count(with_units(cfg, 1)),
                                count(with_units(cfg, 2)), units)


# --------------------------------------------------------------------- #
# Memory per rank
# --------------------------------------------------------------------- #


def _leaves_with_specs(tree, specs):
    """(leaf, spec) of every tensor leaf, specs walked alongside."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_specs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_specs(v, specs[i])
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def _split(spec, mesh_shape: dict) -> int:
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= mesh_shape[axis]
    return n


def input_trees(rules: ShardingRules, specs: dict) -> dict:
    """{name: (tree, its spec tree)} of a cell's inputs under ``rules``,
    sharded as the reference's ``lower_cell`` shards them."""
    out = {"params": (specs["params"], rules.param_specs(specs["params"]))}
    if "opt_state" in specs:
        out["opt_state"] = (specs["opt_state"], rules.opt_state_specs(
            specs["opt_state"], out["params"][1]))
    if "batch" in specs:
        out["batch"] = (specs["batch"], rules.batch_spec(specs["batch"]))
    if "cache" in specs:
        out["cache"] = (specs["cache"], rules.cache_specs(specs["cache"]))
        inputs = {k: specs[k] for k in ("tokens", "embeds")
                  if specs.get(k) is not None}
        in_specs = rules.batch_spec(inputs)
        inputs["pos"], in_specs["pos"] = specs["pos"], P()   # replicated
        out["inputs"] = (inputs, in_specs)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _held(tree) -> int:
    """Bytes of every tensor in a tree of inputs."""
    if isinstance(tree, dict):
        return sum(_held(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_held(v) for v in tree)
    return _nbytes(tree) if isinstance(tree, torch.Tensor) else 0


def memory_per_rank(rules: ShardingRules, specs: dict, mesh_shape: dict,
                    given: dict | None = None) -> dict:
    """Bytes a rank holds, by input: ``planned`` (each leaf of the global
    ``specs`` divided by the product of its spec's axis sizes) and, with
    ``given`` (the tensors the step is given: ``input_specs`` with
    ``par``, on ``meta``), ``held``, their bytes.  Activations are in
    neither, so ``fits`` says whether the inputs fit, not the step."""
    planned = {}
    for name, (tree, spec_tree) in input_trees(rules, specs).items():
        planned[name] = sum(_nbytes(leaf) // _split(spec, mesh_shape)
                            for leaf, spec in _leaves_with_specs(tree,
                                                                 spec_tree))
    planned["total"] = sum(planned.values())
    out = {"planned": planned, "hbm_bytes": rl.HBM_BYTES}
    if given is not None:
        held = {name: _held(given[name]) for name in planned if name in given}
        if "inputs" in planned:
            held["inputs"] = sum(_held(given.get(k)) for k in
                                 ("tokens", "embeds", "pos"))
        held["total"] = sum(held.values())
        out["held"] = held
        out["fits"] = held["total"] <= rl.HBM_BYTES
    return out


# --------------------------------------------------------------------- #
# Cells
# --------------------------------------------------------------------- #


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None) -> dict:
    """Count rank 0's step of one cell (the counterpart of the reference's
    ``lower_cell``): {op_cost, mesh, cfg, shape, memory}."""
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    zero1 = overrides.pop("zero1", False)    # sharding-level, not ModelConfig
    micro = overrides.pop("micro", 1)        # gradient-accumulation slices
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    par = parallel(mesh, shape, zero1)
    rules = par.rules(cfg)
    cost = count_step(cfg, shape, par, mesh.size, micro)
    memory = memory_per_rank(rules, input_specs(cfg, shape), mesh.shape,
                             input_specs(cfg, shape, par))
    return {"op_cost": cost, "mesh": mesh, "cfg": cfg, "shape": shape,
            "memory": memory}


def cell_id(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    out = f"{arch}__{shape_name}__{mesh_name}"
    return out + f"__{tag}" if tag else out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, overrides: dict | None = None,
             tag: str = "") -> dict:
    cid = cell_id(arch, shape_name, multi_pod, tag)
    path = os.path.join(out_dir, cid + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applies(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": cid.split("__")[2],
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "overrides": overrides or {}, "tag": tag,
    }
    if not ok:
        record["status"] = "skip"
        record["reason"] = reason
        _write(path, record)
        return record

    t0 = time.time()
    try:
        cell = trace_cell(arch, shape_name, multi_pod, overrides)
        t_trace = time.time() - t0
        mesh, cost = cell["mesh"], cell["op_cost"]
        roof = rl.derive_from_op_cost(cost, mesh.size,
                                      rl.model_flops(cell["cfg"], shape))
        record.update({
            "status": "ok",
            "n_devices": mesh.size,
            "trace_s": round(t_trace, 2),
            "op_cost": cost.asdict(),
            "roofline": roof.asdict(),
            "memory": cell["memory"],
        })
        print(f"[OK] {cid}: dominant={roof.dominant} "
              f"compute={roof.compute_s:.4f}s memory={roof.memory_s:.4f}s "
              f"collective={roof.collective_s:.4f}s "
              f"useful={roof.useful_flops_ratio:.4g} "
              f"held={cell['memory']['held']['total'] / 2**30:.1f}GiB "
              f"(trace {t_trace:.1f}s)", flush=True)
    except Exception as e:  # a failure here is a bug in the system
        record["status"] = "fail"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {cid}: {type(e).__name__}: {e}", flush=True)
    _write(path, record)
    return record


def calibrate_hook(record: dict, table_dir=None) -> None:
    """Fold a counted cell's roofline terms into the arch's committed
    service-time calibration table (``core.calibration``), if one exists
    in ``table_dir`` (None: the committed tables)."""
    if record.get("status") != "ok" or "roofline" not in record:
        return
    from ..core import calibration as cal
    name = record["arch"]
    try:
        table = cal.load_table(name, table_dir)
    except FileNotFoundError:
        print(f"[calibrate] no committed service table for {name}")
        return
    table = cal.attach_dryrun(table, record)
    path = cal.save_table(table, table_dir)
    print(f"[calibrate] attached {record['shape']} roofline to {path}")


def table(records: list[dict]) -> str:
    """A markdown table of ``ok`` records, one row per (arch, shape),
    pod / multi-pod side by side: rank 0's TFLOP, model_flops over the
    ranks, their ratio (``useful_flops_ratio``), the dominant term,
    ``planned`` and ``held`` GiB a rank, and whether ``held`` fits."""
    cells: dict[tuple, dict] = {}
    for rec in records:
        if rec.get("status") == "ok":
            cells.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = rec
    meshes = ("pod_16x16", "multipod_2x16x16")

    def col(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "-" for m in meshes)

    def gib(n):
        return f"{n / 2**30:.2f}"
    lines = ["| Arch | Shape | Rank 0 TFLOP | model_flops / n TFLOP | "
             "Useful share | Dominant | Planned GiB | Held GiB | Fits |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for (arch, shape), cell in cells.items():
        lines.append("| " + " | ".join([
            arch, shape,
            col(cell, lambda r: f"{r['roofline']['flops_per_chip'] / 1e12:.4g}"),
            col(cell, lambda r: f"{r['roofline']['model_flops_total'] / r['n_devices'] / 1e12:.4g}"),
            col(cell, lambda r: f"{r['roofline']['useful_flops_ratio']:.4g}"),
            col(cell, lambda r: r["roofline"]["dominant"]),
            col(cell, lambda r: gib(r["memory"]["planned"]["total"])),
            col(cell, lambda r: gib(r["memory"]["held"]["total"])),
            col(cell, lambda r: "yes" if r["memory"]["fits"] else "no"),
        ]) + " |")
    return "\n".join(lines)


def _write(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every assigned (arch x shape) cell")
    ap.add_argument("--include-paper-model", action="store_true")
    ap.add_argument("--out", default=OUT_DIR_DEFAULT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], dest="overrides",
                    help="ModelConfig overrides k=v (perf variants)")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument("--calibrate", action="store_true",
                    help="attach each OK cell's roofline terms to the "
                         "arch's committed service-time calibration table")
    ap.add_argument("--table", action="store_true",
                    help="print the cells' records as a markdown table")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.overrides)

    archs = list(ASSIGNED)
    if args.include_paper_model:
        archs = list(REGISTRY)
    if args.arch:
        archs = [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    if not (args.all or args.arch):
        ap.error("pass --all or --arch")

    n_fail = 0
    records = []
    for multi_pod in meshes:          # one fake group size at a time
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, multi_pod, args.out,
                               force=args.force, overrides=overrides,
                               tag=args.tag)
                if args.calibrate:
                    calibrate_hook(rec)
                n_fail += rec.get("status") == "fail"
                records.append(rec)
    if args.table:
        print(table(records))
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
