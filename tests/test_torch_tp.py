"""Tensor and data parallelism of the port over gloo, against its own
single-shard results and the reference's.

One module fixture starts 8 ranks (``tests/torch_tp_worker.py``, one
process each, a gloo group through ``file://`` under the test's
temporary folder) that run every case in that one spawn.  Each rank holds
only its blocks (``ShardingRules``: params, cache, batch rows) and
computes its part; each case runs on a (2, 4) ("data", "model") mesh and
on a (1, 8) one, where the smoke configs' 4 heads are cut in half (the
gather path of attention):

* every smoke arch of ``configs.smoke_config`` (11; jamba's and xlstm's
  at one pattern unit of 8 layers, which holds every block kind of
  theirs): forward logits,
  prefill logits and the rank's cache blocks, 4 decode steps (fed the
  single-shard run's tokens), the loss, the grads (summed over the data
  axes), and one ``make_train_step`` step at ``micro_batches`` 1 and 2
  (loss, ce, aux, grad norm, the first moments, the updated param
  blocks).  The MoE archs run with 6 experts, which divide neither
  model axis, so "auto" resolves to the "local" mode (TP over d_ff, the
  global batch's capacity and queue order), held at the default
  capacity to the single-shard output;
* the four MoE archs with their 8 experts on (2, 4) under "auto"
  (expert parallelism: "ep" for the prompt, "ep_rep" for decode) at
  ``capacity_factor`` 8 (no copy dropped): logits, caches and the
  cross-entropy.  The EP bodies keep
  the reference's per-shard aux (the first shard's value, the mean of
  the shards' grads; ``tests/test_torch_ep.py``), so the aux, the loss
  and the grads are not the single-shard ones there.

Tolerance: within 1e-5 of the largest single-shard value (f32 summation
order: a row-parallel product sums the ranks' partial products, and the
cross-entropy's log-sum-exp and mean are taken over the ranks' blocks).
The updated params are held where the grad is at least 1e-3 of its
leaf's largest (AdamW's first step, see ``tests/test_torch_ep.py``).
The drawn blocks are the single-shard draw's blocks bit for bit.

A subset (qwen2.5-3b, jamba-1.5-large-398b, xlstm-350m,
llava-next-mistral-7b) runs on the reference's weights
(``params_from_jax``), and the sharded logits and loss are held to the
reference's ``forward`` and ``loss_fn`` within the tolerances of
``tests/test_torch_model.py`` (logits 2e-4) and
``tests/test_torch_train.py`` (loss rtol 1e-6 there; 1e-5 here, for the
sums over the ranks).

A test on ``meta`` shows that drawing a rank's blocks of
deepseek-moe-16b at published width on the 16 x 16 mesh cuts every
weight before the next one is drawn, and that the blocks total the
bytes ``ShardingRules`` plans.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.models as jmodels

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESHES = ((2, 4), (1, 8))
ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b", "jamba-1.5-large-398b",
         "llava-next-mistral-7b", "qwen2.5-3b", "minicpm-2b", "smollm-135m",
         "mistral-large-123b", "musicgen-medium", "xlstm-350m",
         "llama-moe-3.5b")
MOE = ("granite-moe-3b-a800m", "deepseek-moe-16b", "jamba-1.5-large-398b",
       "llama-moe-3.5b")
REFERENCE = ("qwen2.5-3b", "jamba-1.5-large-398b", "xlstm-350m",
             "llava-next-mistral-7b")
TOL = 1e-5
# One pattern unit of the two 16-layer smoke configs (every block kind).
DEPTH = {"jamba-1.5-large-398b": {"n_layers": 8},
         "xlstm-350m": {"n_layers": 8}}
B, S = 4, 8


def _jcfg(arch, replace):
    return dataclasses.replace(jcfgs.smoke_config(arch), **replace)


def _cases() -> dict:
    cases = {}
    for i, arch in enumerate(ARCHS):
        rep = dict(DEPTH.get(arch, {}))
        base = dict(rep)
        if arch in MOE:
            rep["n_experts"] = 6
        for mesh in MESHES:
            case = {"arch": arch, "replace": rep, "mesh": mesh,
                    "seed": 100 + i, "params": None}
            if arch in REFERENCE and mesh == MESHES[0]:
                case["params"] = jax.tree.map(np.asarray, jmodels.init_params(
                    _jcfg(arch, rep), jax.random.PRNGKey(i)))
            cases[f"{arch} {mesh}"] = case
            if arch in MOE and mesh == MESHES[0]:
                cases[f"{arch} {mesh} ep"] = dict(
                    case, replace=dict(base, capacity_factor=8.0),
                    params=None)
    return cases


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """(inputs, [rank results]) of one 8-rank gloo run."""
    folder = tmp_path_factory.mktemp("tp")
    inputs = {"cases": _cases(), "meshes": MESHES}
    (folder / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_worker.py"), str(r),
         str(WORLD), str(folder)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errors = []
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        if proc.returncode:
            errors.append(f"rank {r} exit {proc.returncode}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    return inputs, [pickle.loads((folder / f"rank{r}.pkl").read_bytes())
                    for r in range(WORLD)]


CASES = list(_cases())
SINGLE_SHARD = [n for n in CASES if not n.endswith(" ep")]
EP = [n for n in CASES if n.endswith(" ep")]
EP_KEYS = ("forward", "prefill", "decode", "prefill_cache", "cache", "ce")


def _check(res: dict, keys, name: str, rank: int) -> None:
    bad = {k: v for k, v in res["err"].items() if k in keys and v > TOL}
    assert not bad, f"{name} rank {rank}: {bad}"


@pytest.mark.parametrize("name", SINGLE_SHARD)
def test_rank_matches_single_shard(gloo, name):
    """Every result of every rank within 1e-5 of the single-shard one."""
    _, ranks = gloo
    for r, res in enumerate(ranks):
        keys = [k for k in res[name]["err"] if k != "blocks_bitwise"]
        assert len(keys) >= 20
        _check(res[name], keys, name, r)
        assert res[name]["err"].get("blocks_bitwise", True), (name, r)


@pytest.mark.parametrize("name", EP)
def test_expert_parallel_matches_single_shard_outputs(gloo, name):
    """At capacity 8 the EP bodies drop no copy: logits, caches and the
    cross-entropy are the single-shard ones."""
    _, ranks = gloo
    for r, res in enumerate(ranks):
        assert res[name]["resolved"] == "ep", res[name]["resolved"]
        _check(res[name], EP_KEYS, name, r)
        assert res[name]["calls"]["all_to_all"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_local_mode_resolves_where_experts_do_not_divide(gloo, arch):
    """6 experts on a model axis of 4 or 8: "auto" is the "local" mode (TP
    over d_ff), held above to the single-shard output at the default
    capacity."""
    _, ranks = gloo
    for mesh in MESHES:
        assert all(res[f"{arch} {mesh}"]["resolved"] == "local"
                   for res in ranks)
        assert all(res[f"{arch} {mesh}"]["calls"]["all_gather"] > 0
                   for res in ranks)


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_hold_blocks(gloo, mesh):
    """A rank's params are its blocks: on (1, 8) qwen's vocab rows, the
    FFN's columns and the heads' columns are an eighth, the norms whole."""
    _, ranks = gloo
    shapes = ranks[0][f"qwen2.5-3b {mesh}"]["shapes"]
    cfg = jcfgs.smoke_config("qwen2.5-3b")
    m = mesh[1]
    assert (cfg.padded_vocab // m, cfg.d_model) in shapes
    assert (cfg.d_model, cfg.d_ff // m) in shapes
    assert (cfg.d_model, cfg.n_heads * cfg.head_dim // m) in shapes
    assert (cfg.d_model,) in shapes
    assert (cfg.padded_vocab, cfg.d_model) not in shapes


def _reference(arch, case):
    cfg = _jcfg(arch, case["replace"])
    from repro_torch.models import random_batch
    batch = random_batch(cfg, B, S, seed=case["seed"],
                         embed_dtype=torch.float32, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, case["params"])
    prompt = {k: v for k, v in jb.items() if k != "labels"}
    logits, _ = jmodels.forward(cfg, params, prompt)
    loss, _ = jmodels.loss_fn(cfg, params, jb)
    return np.asarray(logits), float(loss)


@pytest.mark.parametrize("arch", REFERENCE)
def test_sharded_matches_reference(gloo, arch):
    """The sharded logits and loss on the reference's weights against the
    reference's single-device ``forward`` and ``loss_fn``."""
    inputs, ranks = gloo
    name = f"{arch} {MESHES[0]}"
    want_logits, want_loss = _reference(arch, inputs["cases"][name])
    for res in ranks:
        np.testing.assert_allclose(res[name]["forward"], want_logits,
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(res[name]["loss"], want_loss, rtol=1e-5)


def test_collectives_were_counted(gloo):
    _, ranks = gloo
    for res in ranks:
        for name in CASES:
            assert res[name]["calls"]["all_reduce"] > 0, name


def test_drawing_blocks_cuts_each_weight_before_the_next():
    """deepseek-moe-16b at published width as rank 0 of the 16 x 16 mesh,
    on ``meta``: every drawn weight is replaced by its block before the
    next one is drawn (so no two whole weights are held at once), and the
    blocks total ``ShardingRules``' planned bytes."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import input_specs
    from repro_torch.configs import SHAPES
    from repro_torch.models import Parallel, init_params
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_leaves

    class Mesh:                          # rank 0 of the pod, no process group
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}
        size = 256

        def coordinate(self):
            return {"data": 0, "model": 0}

    cfg = get_config("deepseek-moe-16b")
    events = []
    real_randn, real_block = torch.randn, sharding.rank_block

    def randn(*a, **k):
        out = real_randn(*a, **k)
        if out.device.type == "meta":
            events.append(("draw", out.numel()))
        return out

    def block(x, *a, **k):
        events.append(("cut", x.numel()))
        return real_block(x, *a, **k)

    par = Parallel(mesh=Mesh())
    torch.randn = randn
    model_mod.rank_block = block
    try:
        params = init_params(cfg, torch.Generator(), "meta", cast=False,
                             par=par)
    finally:
        torch.randn = real_randn
        model_mod.rank_block = real_block
    # Drop the first pass (which finds each weight's leaf): it cuts nothing.
    first_cut = next(i for i, e in enumerate(events) if e[0] == "cut")
    draws = [e for e in events[:first_cut] if e[0] == "draw"]
    last_draw = max(i for i, e in enumerate(events) if e[0] == "draw")
    real = events[first_cut - 1:last_draw + 2]
    assert real[0][0] == "draw" and len(draws) > 100
    for a, b in zip(real[::2], real[1::2]):
        assert a[0] == "draw" and b == ("cut", a[1]), (a, b)
    whole = sum(n for _, n in draws)
    held = sum(t.numel() for t in tree_leaves(params))
    assert held < whole / 8
    rules = sharding.ShardingRules(cfg, Mesh())
    specs = input_specs(cfg, SHAPES["decode_32k"])
    mem = dryrun.memory_per_rank(rules, specs, Mesh.shape)
    assert held * 4 == mem["planned"]["params"]
