"""One rank of the port's tensor- and data-parallel checks over gloo (CPU).

    python tests/torch_tp_worker.py RANK WORLD DIR

``tests/test_torch_tp.py`` starts WORLD (8) of these (PYTHONPATH=src),
after writing ``DIR/inputs.pkl``: the cases (arch, config changes, mesh,
and the reference's weights as numpy trees where a case takes
them).  Each rank joins a gloo group through ``file://DIR/rendezvous``
and runs every case twice: single-shard (``Parallel()``, the whole model
and batch) and as its rank of the case's mesh, on its blocks
(``init_params(par=...)``, or the reference's weights cut by
``shard_tree``).  It writes ``DIR/rank{RANK}.pkl``: per case, the largest
difference of each sharded result from the single-shard one relative to
the largest single-shard value (``err``), and the global sharded results
the test holds to the reference.  Imports no JAX.
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
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (_value_and_grad, make_serve_step,
                                      make_train_step)
from repro_torch.models import (Parallel, forward, init_params, prefill,
                                random_batch)
from repro_torch.models.model import gather_logits
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves, tree_map

B, S, DECODE, LR = 4, 8, 4, 1e-2


def _cfg(case: dict):
    return dataclasses.replace(smoke_config(case["arch"]), **case["replace"])


def err(got: torch.Tensor, want: torch.Tensor, mask=None,
        scale: float | None = None) -> float:
    """max |got - want| over max |want| (over ``mask`` where given;
    ``scale`` in place of max |want|: a block is held relative to its
    whole tensor's largest value)."""
    got, want = got.detach().double(), want.detach().double()
    if got.shape != want.shape:
        return float("inf")
    if mask is not None:
        got, want = got[mask], want[mask]
    if want.numel() == 0:
        return 0.0
    scale = scale or float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def worst(pairs) -> float:
    return max((err(g, w) for g, w in pairs), default=0.0)


def worst_blocks(got, whole, specs, mesh, masks=None) -> float:
    """``err`` of each of the rank's blocks ``got`` against its block of
    ``whole``, relative to the whole leaf's largest value."""
    wants = tree_leaves(shard_tree(whole, specs, mesh))
    masks = masks or [None] * len(wants)
    return max((err(g, w, m, float(x.detach().abs().max()))
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


def _decode_inputs(cfg, seed: int):
    """Per step, the audio frontend's embeds (None for token archs)."""
    if cfg.frontend != "audio":
        return [None] * DECODE
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(B, 1, cfg.d_model, generator=gen) for _ in range(DECODE)]


def run(case, cfg, par, batch, single=None) -> dict:
    """Every result of one case under ``par``; with ``single`` (the
    single-shard results) the decode steps take its tokens, and the
    errors against it are returned instead of the results."""
    mesh = par.mesh
    rules = par.rules(cfg) if mesh is not None else None
    rows = (lambda t: par.rows(t)) if mesh is not None else (lambda t: t)
    params = _params(case, cfg, par)
    prompt = {k: rows(v) for k, v in batch.items() if k != "labels"}
    out: dict = {}
    with torch.no_grad():
        logits, aux = forward(cfg, params, prompt, par)
        out["forward"] = gather_logits(cfg, logits, par)
        out["aux"] = aux
        max_len = S + DECODE + 1
        last, cache = prefill(cfg, params, prompt, max_len, par)
        out["prefill"] = gather_logits(cfg, last, par)
        out["prefill_cache"] = cache
        step = make_serve_step(cfg, par)
        tokens = (single or out)["prefill"].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((B,), S, dtype=torch.int32)
        outs, caches = [], []
        embeds = _decode_inputs(cfg, case["seed"])
        for i in range(DECODE):
            tok_in = None if cfg.frontend == "audio" else tokens
            nxt, lg, cache = step(params, cache, tok_in, pos, embeds[i])
            outs.append(lg)
            tokens = single["decode_tokens"][i] if single else nxt
            if not single:
                out.setdefault("decode_tokens", []).append(nxt)
            pos = pos + 1
        out["decode"] = outs
        out["cache"] = cache
    whole_batch = {k: rows(v) for k, v in batch.items()}
    (loss, met), grads = _value_and_grad(cfg, par, params, whole_batch)
    out["loss"], out["ce"], out["grads"] = loss, met["ce"], grads
    for micro in (1, 2):
        p = tree_map(lambda t: t.clone(), params)
        state = adamw_init(p)
        p, state, m = make_train_step(cfg, par, AdamWConfig(lr=LR),
                                      micro_batches=micro)(p, state,
                                                           whole_batch)
        out[f"train{micro}"] = {"params": p, "metrics": m, "mu": state["mu"]}
    if single is None:
        return out
    # ---- errors against the single-shard results ----
    pspec = rules.param_specs(single["grads"])
    cspec = rules.cache_specs(single["cache"])

    def blocks(tree, specs):
        return shard_tree(tree, specs, mesh)

    e = {"forward": err(out["forward"], single["forward"]),
         "prefill": err(out["prefill"], single["prefill"]),
         "decode": worst(zip(out["decode"], single["decode"])),
         "prefill_cache": worst_blocks(out["prefill_cache"],
                                       single["prefill_cache"], cspec, mesh),
         "cache": worst_blocks(out["cache"], single["cache"], cspec, mesh),
         "aux": err(out["aux"], single["aux"]),
         "loss": err(out["loss"], single["loss"]),
         "ce": err(out["ce"], single["ce"]),
         "grads": worst_blocks(out["grads"], single["grads"], pspec, mesh)}
    for micro in (1, 2):
        got, want = out[f"train{micro}"], single[f"train{micro}"]
        for k in ("loss", "ce", "aux", "grad_norm"):
            e[f"train{micro} {k}"] = err(got["metrics"][k], want["metrics"][k])
        e[f"train{micro} mu"] = worst_blocks(got["mu"], want["mu"], pspec,
                                             mesh)
        # AdamW's first step moves a weight by lr * g / (|g| + eps), whose
        # derivative in g is lr * eps / (|g| + eps)^2: where |g| is small a
        # rounding of g moves the weight far more than it moves g.  So the
        # params are held where the step's first moment (0.1 g) is at
        # least 1e-2 of its leaf's largest.
        masks = [m.abs() >= 1e-2 * float(w.abs().max()) for m, w in zip(
            tree_leaves(blocks(want["mu"], pspec)), tree_leaves(want["mu"]))]
        e[f"train{micro} params"] = worst_blocks(
            got["params"], want["params"], pspec, mesh, masks)
    # the draws are the single-shard draw's blocks, bit for bit
    if case.get("params") is None:
        e["blocks_bitwise"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(_params(case, cfg, par)),
            tree_leaves(blocks(_params(case, cfg, Parallel()), pspec))))
    return {"err": e, "forward": out["forward"].numpy(),
            "loss": float(out["loss"]), "grad_norm": float(
                out["train1"]["metrics"]["grad_norm"]),
            "shapes": [tuple(t.shape) for t in tree_leaves(params)]}


def main(rank: int, world: int, folder: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = pickle.loads((folder / "inputs.pkl").read_bytes())
        meshes = {shape: make_mesh(shape, ("data", "model"), "cpu")
                  for shape in inputs["meshes"]}
        res, singles = {}, {}
        for name, case in inputs["cases"].items():
            cfg = _cfg(case)
            batch = random_batch(cfg, B, S, seed=case["seed"],
                                 embed_dtype=torch.float32, device="cpu")
            key = (case["arch"], repr(case["replace"]), case["seed"],
                   case["params"] is None)
            if key not in singles:        # one single-shard run for both meshes
                singles[key] = run(case, cfg, Parallel(), batch)
            single = singles[key]
            par = Parallel(mesh=meshes[case["mesh"]])
            collectives.reset_counts()
            res[name] = run(case, cfg, par, batch, single)
            res[name]["calls"] = dict(collectives.calls)
            res[name]["resolved"] = par.resolve_moe(cfg, S) \
                if cfg.has_moe else None
        (folder / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
