"""One rank of the port's ZeRO-1, context-parallel and sharded-checkpoint
checks over gloo (CPU).

    python tests/torch_zero_cp_worker.py RANK WORLD DIR

``tests/test_torch_zero_cp.py`` starts WORLD (8) of these (PYTHONPATH=src)
after writing ``DIR/inputs.pkl``: the cases and, where a case takes
them, the reference's weights as numpy trees.  Each rank joins a gloo
group through ``file://DIR/rendezvous`` and writes ``DIR/rank{RANK}.pkl``:
per case the largest difference of each sharded result from the
single-shard one relative to the largest single-shard value (``err``),
flags that must hold (``ok``), and the global results the test holds to
the reference.  Every rank also runs the single-shard steps itself.
Imports no JAX.

* "zero": ``STEPS`` train steps under ``Parallel(zero_opt=True)``, held
  to the same mesh without ZeRO and to the single-shard steps: the
  losses and grad norms of the run, and the moments' slices and the
  params' blocks after each step started from the other run's state
  before it (run freely, AdamW turns roundings of grads near its eps
  into moves of lr, which the later steps carry: the sharded run
  without ZeRO drifts from the single-shard one so too); and each
  rank's moment bytes against the non-ZeRO blocks';
* "cp": batch-1 prefill and decode with the cache's sequence split over
  the data axes (``Parallel(context=True)``), held to the single-shard
  run (logits, the cache's blocks);
* "ckpt": a ZeRO run's checkpoints: step 0's file against the
  single-shard run's, a file written on this mesh restored on another,
  and a resume against straight steps.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, save_pytree
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import rank_block, shard_tree
from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (make_serve_step, make_train_step,
                                      norm_groups, zero_split)
from repro_torch.models import (Parallel, init_params, prefill,
                                random_batch)
from repro_torch.models.model import gather_logits
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map

B, S, STEPS, LR, WORLD = 4, 8, 3, 1e-2, 8
CP_LEN, CP_PROMPT, CP_DECODE = 16, 3, 4


def _cfg(case: dict):
    return dataclasses.replace(smoke_config(case["arch"]), **case["replace"])


def err(got, want, scale=None, mask=None) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if got.shape != want.shape:
        return float("inf")
    if mask is not None:
        got, want = got[mask], want[mask]
    if want.numel() == 0:
        return 0.0
    scale = scale or float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def worst_blocks(got, whole, specs, mesh, masks=None) -> float:
    """``err`` of each of the rank's blocks against its block of
    ``whole``, relative to the whole leaf's largest value."""
    wants = tree_leaves(shard_tree(whole, specs, mesh))
    masks = masks or [None] * len(wants)
    return max((err(g, w, float(x.abs().max()) or 1.0, m)
                for g, w, m, x in zip(tree_leaves(got), wants, masks,
                                      tree_leaves(whole))), default=0.0)


def _params(case, cfg, par):
    if case.get("params") is not None:
        whole = params_from_jax(cfg, case["params"], "cpu")
        if par.mesh is None:
            return whole
        return shard_tree(whole, par.rules(cfg).param_specs(whole), par.mesh)
    gen = torch.Generator().manual_seed(case["seed"])
    return init_params(cfg, gen, "cpu", cast=False, par=par)


def _batch(cfg, par, seed):
    batch = random_batch(cfg, B, S, seed=seed, embed_dtype=torch.float32,
                         device="cpu")
    return {k: par.rows(v) for k, v in batch.items()}


def _specs(cfg, par):
    """(param specs, opt-state specs) of ``par``'s rules for the global
    leaves."""
    rules = par.rules(cfg)
    whole = init_params(cfg, torch.Generator(), "meta", cast=False)
    p_specs = rules.param_specs(whole)
    return p_specs, rules.opt_state_specs(adamw_init(whole), p_specs)


def train(cfg, par, params, steps: int, seed: int, state=None, first=0,
          kept=None):
    """``steps`` train steps from step ``first``: (params, state, metrics);
    ``kept``, a list, takes a copy of (params, state) before each step and
    after the last."""
    state = state or adamw_init(params, zero_split(cfg, par))
    step = make_train_step(cfg, par, AdamWConfig(lr=LR))
    metrics = []
    for i in range(first, first + steps):
        if kept is not None:
            kept.append(tree_map(torch.clone, (params, state)))
        params, state, m = step(params, state, _batch(cfg, par, seed + i))
        metrics.append({k: float(v) for k, v in m.items()})
    if kept is not None:
        kept.append(tree_map(torch.clone, (params, state)))
    return params, state, metrics


def _masks(mu_whole, p_specs, mesh) -> list:
    """Where the params are held: AdamW moves a weight by
    lr * m / (sqrt(v) + eps), and where |g| nears eps a rounding of g
    moves it far more than it moves g, so where the single-shard first
    moment is at least 1e-2 of its leaf's largest."""
    return [mu.abs() >= 1e-2 * float(w.abs().max()) for mu, w in zip(
        tree_leaves(shard_tree(mu_whole, p_specs, mesh)),
        tree_leaves(mu_whole))]


def zero_case(case, cfg, mesh) -> dict:
    kept: list = []
    single = train(cfg, Parallel(), _params(case, cfg, Parallel()), STEPS,
                   case["seed"], kept=kept)
    plain_par = Parallel(mesh=mesh)
    zero_par = Parallel(mesh=mesh, zero_opt=True)
    kept_plain: list = []
    plain = train(cfg, plain_par, _params(case, cfg, plain_par), STEPS,
                  case["seed"], kept=kept_plain)
    collectives.reset_counts()
    zero = train(cfg, zero_par, _params(case, cfg, zero_par), STEPS,
                 case["seed"])
    calls = dict(collectives.calls)
    # A dry-run count of one more step reports the new collectives under
    # the reference's HLO names.
    cost, _ = op_analysis.analyze(
        make_train_step(cfg, zero_par, AdamWConfig(lr=LR)),
        *tree_map(torch.clone, (zero[0], zero[1])),
        _batch(cfg, zero_par, case["seed"]), n_devices=WORLD)
    p_specs, o_specs = _specs(cfg, zero_par)
    e, ok = {}, {}
    for name, want in (("single", single), ("plain", plain)):
        for k in ("loss", "grad_norm"):
            e[f"{k} vs {name}"] = max(err(z[k], w[k]) for z, w in zip(
                zero[2], want[2]))
    e["norm0 vs single"] = err(zero[2][0]["grad_norm"],
                               single[2][0]["grad_norm"])
    # Each ZeRO step from the other run's state before it (the rank's
    # blocks and slices of it), against that run's state after it.
    whole = [tree_map(torch.clone, kept_plain[i]) for i in range(STEPS + 1)]
    whole = [(sharding.unshard_tree(p, p_specs, mesh),
              {"mu": sharding.unshard_tree(st["mu"], p_specs, mesh),
               "nu": sharding.unshard_tree(st["nu"], p_specs, mesh),
               "count": st["count"]}) for p, st in whole]
    for name, states in (("single", kept), ("plain", whole)):
        for m in ("mu", "nu", "params"):
            e[f"{m} vs {name}"] = 0.0
        for i in range(STEPS):
            (p0, s0), (p1, s1) = states[i], states[i + 1]
            # (copies: a block that splits nothing is the leaf itself)
            state = tree_map(torch.clone, {
                "mu": shard_tree(s0["mu"], o_specs["mu"], mesh),
                "nu": shard_tree(s0["nu"], o_specs["mu"], mesh),
                "count": s0["count"]})
            got_p, got_s, _ = train(
                cfg, zero_par, tree_map(torch.clone, shard_tree(
                    p0, p_specs, mesh)), 1, case["seed"], state, first=i)
            for m in ("mu", "nu"):
                e[f"{m} vs {name}"] = max(e[f"{m} vs {name}"], worst_blocks(
                    got_s[m], s1[m], o_specs["mu"], mesh))
            e[f"params vs {name}"] = max(
                e[f"params vs {name}"], worst_blocks(
                    got_p, p1, p_specs, mesh, _masks(s1["mu"], p_specs,
                                                     mesh)))
    # Moment bytes: 1/n_data of the non-ZeRO blocks' where the dim divides.
    cuts = tree_leaves(zero_split(cfg, zero_par), tuple_leaves=True)
    zb = [t.numel() * t.element_size() for t in tree_leaves(zero[1]["mu"])]
    pb = [t.numel() * t.element_size() for t in tree_leaves(plain[1]["mu"])]
    ok["bytes"] = all(z * zero_par.n_data == p if c is not None else z == p
                      for z, p, c in zip(zb, pb, cuts))
    ok["some cut"] = any(c is not None for c in cuts)
    ok["counted"] = cost.collective_counts.get("reduce-scatter") == sum(
        c is not None for c in cuts) and cost.collective_counts.get(
        "all-gather", 0) >= sum(c is not None for c in cuts)
    # global_norm with ZeRO's groups: the rank's slices of the single-shard
    # step's moments (any tree of the params' structure will do) against
    # their whole norm.
    slices = shard_tree(single[1]["mu"], o_specs["mu"], mesh)
    e["global_norm"] = err(global_norm(slices, norm_groups(cfg, zero_par)),
                           global_norm(single[1]["mu"]))
    return {"err": e, "ok": ok, "calls": calls,
            "moment_bytes": (sum(zb), sum(pb)),
            "losses": [m["loss"] for m in zero[2]]}


def cp_case(case, cfg, mesh) -> dict:
    """Batch-1 prefill and ``CP_DECODE`` decode steps, single-shard and
    with the cache's sequence split over ``mesh``'s data axes."""
    prompt = {"tokens": random_batch(cfg, 1, CP_PROMPT, seed=case["seed"],
                                     device="cpu")["tokens"]}
    runs = {}
    for name, par in (("single", Parallel()),
                      ("cp", Parallel(mesh=mesh, batch_split=False,
                                      context=True))):
        params = _params(case, cfg, par)
        ops.reset_launch_counts()
        with torch.no_grad():
            last, cache = prefill(cfg, params, prompt, CP_LEN, par)
            logits = [gather_logits(cfg, last, par)]
            step = make_serve_step(cfg, par)
            tokens = runs["single"]["tokens"] if name == "cp" else \
                [logits[0].argmax(-1).to(torch.int32)[:, None]]
            pos = torch.full((1,), CP_PROMPT, dtype=torch.int32)
            for i in range(CP_DECODE):
                nxt, lg, cache = step(params, cache, tokens[i], pos)
                logits.append(lg)
                if name == "single":
                    tokens.append(nxt)
                pos = pos + 1
        runs[name] = {"logits": logits, "cache": cache, "tokens": tokens,
                      "launches": ops.launch_counts()}
    single, cp = runs["single"], runs["cp"]
    par = Parallel(mesh=mesh, batch_split=False, context=True)
    c_specs = par.rules(cfg).cache_specs(single["cache"])
    e = {"prefill": err(cp["logits"][0], single["logits"][0]),
         "decode": max(err(a, b) for a, b in zip(cp["logits"][1:],
                                                  single["logits"][1:])),
         "cache": worst_blocks(cp["cache"], single["cache"], c_specs, mesh)}
    # The split cache through a sharded checkpoint: the file's whole
    # leaves against the single-shard cache.
    path = str(Path(case["dir"]) / f"cache_{case['name']}.npz")
    save_pytree(path, cp["cache"], c_specs, mesh)
    with np.load(path) as data:
        e["cache file"] = max(err(torch.from_numpy(data[f"leaf_{i}"]), w)
                              for i, w in enumerate(tree_leaves(
                                  single["cache"])))
    kv = [t for t in tree_leaves(cp["cache"]) if t.dim() == 4]
    return {"err": e, "ok": {"seq split": all(
        t.shape[1] == CP_LEN // par.n_data for t in kv) and bool(kv)},
        "logits": [t.numpy() for t in cp["logits"]],
        "tokens": [t.numpy() for t in single["tokens"]],
        "prompt": prompt["tokens"].numpy(),
        "launches": cp["launches"]}


def _tree_bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def ckpt_case(case, cfg, meshes, folder: Path) -> dict:
    """Sharded checkpoints of a ZeRO run on ``meshes[0]`` (module
    docstring); ``meshes[1]`` restores them."""
    mesh, other = meshes
    par = Parallel(mesh=mesh, zero_opt=True)
    p_specs, o_specs = _specs(cfg, par)
    specs = {"params": p_specs, "opt_state": o_specs}
    ok = {}
    # Step 0: the file of the rank's blocks against the single-shard file.
    params = _params(case, cfg, par)
    state = adamw_init(params, zero_split(cfg, par))
    CheckpointManager(str(folder / "mesh")).save(
        0, {"params": params, "opt_state": state}, specs, mesh)
    if dist.get_rank() == 0:
        whole = _params(case, cfg, Parallel())
        CheckpointManager(str(folder / "single")).save(
            0, {"params": whole, "opt_state": adamw_init(whole)})
    dist.barrier()
    with np.load(folder / "mesh" / "step_0.npz") as a, \
            np.load(folder / "single" / "step_0.npz") as b:
        ok["step 0 file bitwise"] = sorted(a.files) == sorted(b.files) \
            and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                    for k in a.files)
    # Straight steps against 2 steps, a save, a restore and 1 more step.
    straight = train(cfg, par, params, STEPS, case["seed"])
    params = _params(case, cfg, par)
    p2, s2, _ = train(cfg, par, params, STEPS - 1, case["seed"])
    manager = CheckpointManager(str(folder / "resume"))
    manager.save(STEPS - 1, {"params": p2, "opt_state": s2}, specs, mesh)
    like = {"params": tree_map(torch.zeros_like, p2),
            "opt_state": tree_map(torch.zeros_like, s2)}
    step, back = manager.restore_latest(like, specs, mesh)
    ok["restored bitwise"] = step == STEPS - 1 and _tree_bitwise(
        back, {"params": p2, "opt_state": s2})
    resumed = train(cfg, par, back["params"], 1, case["seed"],
                    back["opt_state"], first=STEPS - 1)
    ok["resume bitwise"] = _tree_bitwise(resumed[0], straight[0]) \
        and _tree_bitwise(resumed[1], straight[1])
    # The file written on ``mesh`` restored on ``other``: each block is
    # rank_block of the file's whole leaf, bit for bit.
    o_par = Parallel(mesh=other, zero_opt=True)
    op_specs, oo_specs = _specs(cfg, o_par)
    o_like_p = _params(case, cfg, o_par)
    o_like = {"params": o_like_p,
              "opt_state": adamw_init(o_like_p, zero_split(cfg, o_par))}
    o_specs_tree = {"params": op_specs, "opt_state": oo_specs}
    _, got = manager.restore_latest(o_like, o_specs_tree, other)
    with np.load(folder / "resume" / f"step_{STEPS - 1}.npz") as data:
        wholes = [torch.from_numpy(data[f"leaf_{i}"])
                  for i in range(len(data.files))]
    from repro_torch.checkpoint.store import _with_specs
    want = [rank_block(w, spec, other, fused).to(g.dtype)
            for w, g, (_, spec, fused) in zip(
                wholes, tree_leaves(got), _with_specs(o_like, o_specs_tree))]
    ok["other mesh bitwise"] = all(
        g.shape == w.shape and torch.equal(g, w)
        for g, w in zip(tree_leaves(got), want))
    ok["other mesh is not this one"] = any(
        a.shape != b.shape for a, b in zip(tree_leaves(got),
                                           tree_leaves(back)))
    return {"ok": ok}


def main(rank: int, world: int, folder: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = pickle.loads((folder / "inputs.pkl").read_bytes())
        meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
                  for shape in inputs["meshes"]}
        res = {}
        for name, case in inputs["cases"].items():
            cfg = _cfg(case)
            if case["kind"] == "zero":
                res[name] = zero_case(case, cfg, meshes[case["mesh"]])
            elif case["kind"] == "cp":
                case = dict(case, dir=str(folder), name=name.replace(" ", "_"))
                res[name] = cp_case(case, cfg, meshes[case["mesh"]])
            else:
                sub = folder / name.replace(" ", "_")
                res[name] = ckpt_case(case, cfg, [meshes[m] for m in
                                                  case["meshes"]], sub)
        (folder / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
