"""One rank of the port's expert-parallel checks over gloo (CPU).

    python tests/torch_ep_worker.py RANK WORLD DIR
    python tests/torch_ep_worker.py fake WORLD DIR

``tests/test_torch_ep.py`` starts WORLD of these (PYTHONPATH=src), after
writing ``DIR/inputs.pkl``: the reference's weights as numpy trees and
the inputs, made from numpy seeds.  Each rank joins a gloo group through
``file://DIR/rendezvous``, runs every case on a (2, 4) ("data", "model")
mesh (the train step on a (1, 8) one) on its blocks (``shard_tree`` of
the weights by ``ShardingRules``, its rows of the tokens), puts the
global outputs and grads together again (the grads summed over the data
axes first, as the train step sums them), and writes its results to
``DIR/rank{RANK}.pkl`` as numpy arrays, with the collective records
of the sharded loss (d) and the sharded train step (e), which run under
``launch.op_analysis.analyze``.  With ``fake`` in place of a rank, one
process joins a fake group of WORLD ranks as rank 0
(``launch.dryrun.fake_group``) and runs (d) and (e) on ``meta`` tensors
of the same shapes under ``launch.op_analysis.analyze``, writing their
records and counts to ``DIR/fake.pkl``.  Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import shard_tree, unshard_tree
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import _value_and_grad, make_train_step
from repro_torch.models import Parallel, loss_fn
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _cfg(case: dict):
    return dataclasses.replace(smoke_config(case["arch"]), **case["replace"])


def _global(par, tree, specs):
    """The global tree from the ranks' blocks: grads summed over the data
    axes (each rank's are its rows' part), then gathered."""
    if par.mesh is None:
        return tree
    if par.dp:
        tree = tree_map(lambda t: collectives.all_reduce(
            t, par.data_group()), tree)
    return unshard_tree(tree, specs, par.mesh)


def _rows_whole(par, y):
    """The global rows of ``y`` from every data rank's block."""
    if not par.dp:
        return y
    return torch.cat(collectives.all_gather(y, par.data_group()))


def _layer(cfg, params, x, cot, par):
    """(y, aux, grads of sum(y * cot), the router's grad of the aux term)
    of one MoE block under ``par``, on the rank's blocks of ``params``
    (the whole model's, block 0's MoE) and its rows of ``x`` and
    ``cot``; y and the grads put together again."""
    specs = par.rules(cfg).param_specs(params) if par.mesh else None
    held = shard_tree(params, specs, par.mesh) if par.mesh else params
    ffn = held["layers"][0]["ffn"]
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), ffn)
    named = {k: live[k] for k in ("w_gate", "w_up", "w_down", "router")}
    named.update({f"shared/{k}": v for k, v in live.get("shared", {}).items()})
    y, aux = model_mod._apply_moe(cfg, live, par.rows(x), par, F32)
    grads = torch.autograd.grad((y * par.rows(cot)).sum(),
                                list(named.values()), retain_graph=True)
    term = aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"]
    aux_grad, = torch.autograd.grad(term, live["router"])
    fspecs = specs["layers"][0]["ffn"] if specs else None
    gspecs = {k: (fspecs[k.split("/")[0]] if "/" not in k
                  else fspecs["shared"][k.split("/")[1]]) for k in named} \
        if specs else None
    grads = _global(par, dict(zip(named, grads)), gspecs)
    aux_grad = _global(par, aux_grad, fspecs["router"] if specs else None)
    return {"y": _rows_whole(par, y.detach()).numpy(), "aux": _np(aux),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "aux_grad": aux_grad.numpy()}


def run_layers(inputs, mesh) -> dict:
    out = {}
    for name, case in inputs["layers"].items():
        cfg = _cfg(case)
        params = params_from_jax(cfg, case["params"], "cpu")
        x, cot = torch.from_numpy(case["x"]), torch.from_numpy(case["cot"])
        res = {"local": _layer(cfg, params, x, cot, Parallel())}
        for mode in case["modes"]:
            par = Parallel(mesh=mesh, moe_mode=mode)
            res[mode] = _layer(cfg, params, x, cot, par)
        res["resolved"] = Parallel(mesh=mesh).resolve_moe(cfg, x.shape[1])
        out[name] = res
    return out


def _captured_aux(cfg, params, batch, blocks) -> float:
    """The aux term the sharded loss should hold: the single-shard run's
    MoE inputs, each block's router aux on the first rank's slice."""
    seen = []
    local = moe_mod.moe_apply_local

    def record(cfg_, p, x, cdt):
        seen.append((p, x.detach()))
        return local(cfg_, p, x, cdt)

    moe_mod.moe_apply_local = record
    try:
        loss_fn(cfg, params, batch)
    finally:
        moe_mod.moe_apply_local = local
    total = 0.0
    for p, h in seen:
        _, aux = local(cfg, p, h[blocks], F32)
        total += float(aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"])
    return total


def run_loss(inputs, mesh) -> dict:
    out = {}
    for name, case in inputs["loss"].items():
        cfg = _cfg(case)
        params = params_from_jax(cfg, case["params"], "cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        par = Parallel(mesh=mesh)
        held = shard_tree(params, par.rules(cfg).param_specs(params), mesh)
        records = []
        with torch.no_grad():
            _, (sharded, met) = op_analysis.analyze(
                loss_fn, cfg, held, {k: par.rows(v) for k, v in batch.items()},
                par, records=records)
            single, smet = loss_fn(cfg, params, batch)
            first = _captured_aux(cfg, params, batch, case["first_block"])
        out[name] = {"loss": sharded.numpy(), "ce": met["ce"].numpy(),
                     "aux": met["aux"].numpy(), "single": single.numpy(),
                     "single_ce": smet["ce"].numpy(), "first_aux": first,
                     "records": records}
    return out


def run_train(inputs, mesh) -> dict:
    case = inputs["train"]
    cfg = _cfg(case)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    out = {}
    for name, par in (("single", Parallel()),
                      ("sharded", Parallel(mesh=mesh, moe_mode="ep_rep"))):
        params = params_from_jax(cfg, case["params"], "cpu")
        specs = par.rules(cfg).param_specs(params) if par.mesh else None
        if specs:
            params = shard_tree(params, specs, mesh)
        _, grads = _value_and_grad(cfg, par, params, batch)
        state = adamw_init(params)
        step = make_train_step(cfg, par, AdamWConfig(lr=case["lr"]))
        records = []
        _, (params, state, met) = op_analysis.analyze(
            step, params, state, batch, records=records)
        if specs:      # the grads are summed over the data axes already
            grads = unshard_tree(grads, specs, mesh)
            params = unshard_tree(params, specs, mesh)
        out[name] = {"params": [t.numpy() for t in tree_leaves(params)],
                     "grads": [g.numpy() for g in tree_leaves(grads)],
                     "metrics": {k: float(v) for k, v in met.items()},
                     "records": records}
    return out


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def run_fake(inputs, world: int, folder: Path) -> None:
    """(d)'s sharded loss and (e)'s sharded step on ``meta`` tensors as
    rank 0 of a fake group, counted by ``op_analysis``."""
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    dryrun.fake_group(world)
    try:
        out = {}
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        par = Parallel(mesh=mesh)
        for name, case in inputs["loss"].items():
            cfg = _cfg(case)
            params = init_params(cfg, torch.Generator(), "meta", cast=False,
                                 par=par)
            batch = _meta({k: par.rows(torch.from_numpy(v))
                           for k, v in case["batch"].items()})
            records = []
            with torch.no_grad():
                cost, _ = op_analysis.analyze(
                    loss_fn, cfg, params, batch, par,
                    n_devices=world, records=records)
            out[name] = {"records": records, "cost": cost.asdict()}
        case = inputs["train"]
        cfg = _cfg(case)
        par = Parallel(mesh=make_mesh((1, 8), ("data", "model"), "cpu"),
                       moe_mode="ep_rep")
        params = init_params(cfg, torch.Generator(), "meta", cast=False,
                             par=par)
        batch = _meta({k: torch.from_numpy(v) for k, v in case["batch"].items()})
        step = make_train_step(cfg, par, AdamWConfig(lr=case["lr"]))
        records = []
        cost, _ = op_analysis.analyze(step, params, adamw_init(params), batch,
                                      n_devices=world, records=records)
        out["train"] = {"records": records, "cost": cost.asdict()}
        (folder / "fake.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def main(rank: int, world: int, folder: Path) -> None:
    torch.set_num_threads(1)
    if rank < 0:
        run_fake(pickle.loads((folder / "inputs.pkl").read_bytes()), world,
                 folder)
        return
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = pickle.loads((folder / "inputs.pkl").read_bytes())
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        res = {"coordinate": mesh.coordinate(),
               "group_sizes": {a: dist.get_world_size(mesh.group(a))
                               for a in mesh.axis_names}}
        res["layers"] = run_layers(inputs, mesh)
        res["loss"] = run_loss(inputs, mesh)
        res["train"] = run_train(inputs, make_mesh((1, 8), ("data", "model"),
                                                   "cpu"))
        res["calls"] = dict(collectives.calls)
        (folder / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(-1 if sys.argv[1] == "fake" else int(sys.argv[1]), int(sys.argv[2]),
         Path(sys.argv[3]))
