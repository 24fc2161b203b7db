"""ZeRO-1, context-parallel batch-1 decode and sharded checkpoints over
gloo, against the port's single-shard results and the reference's.

One module fixture starts 8 ranks (``tests/torch_zero_cp_worker.py``, one
process each, a gloo group through ``file://`` under the test's temporary
folder) that run every case in that one spawn, on the ("data", "model")
meshes (2, 4), (4, 2) and (8, 1):

* ZeRO-1 (``Parallel(zero_opt=True)``): 3 train steps of qwen2.5-3b,
  granite-moe-3b-a800m and jamba-1.5-large-398b (one pattern unit of 8
  layers) at the smoke sizes, the MoE archs with 5 experts (dividing
  neither model axis: the "local" mode, whose values are the
  single-shard ones), on (2, 4) and (4, 2), against the same mesh
  without ZeRO and against the single-shard steps: the run's losses and
  grad norms, and the moments' slices and the params' blocks after each
  step started from the other run's state before it, within 1e-5 of
  the largest value (f32; the reduce-scatter and the all-reduce sum in
  different orders; params held where the first moment is at least
  1e-2 of its leaf's largest, as ``tests/test_torch_tp.py`` holds them).
  Each rank's moments take 1/n_data of the non-ZeRO blocks' bytes where
  the chosen dim divides (a dry-run count of a step reports one
  reduce-scatter a cut leaf and the all-gathers under the reference's
  HLO names);
  ``global_norm`` over ZeRO's groups equals the whole norm within 1e-6.
  qwen2.5-3b on (2, 4) runs on the reference's weights
  (``params_from_jax``), its losses held to the reference's jitted
  ``make_train_step`` on one device (rtol 1e-5).
* Context parallelism (``Parallel(batch_split=False, context=True)``):
  qwen2.5-3b and jamba at batch 1 on (4, 2) and (8, 1) (blocks of 4 and
  2 rows of a 16-row cache), a 3-token prompt and 4 decode steps at
  positions 3 to 6 (some ranks' windows empty, some steps on a block's
  first row), on the reference's weights: logits and the cache's blocks
  against the single-shard run (1e-5), the logits against the
  reference's ``prefill`` and ``decode_step`` (2e-4, as
  ``tests/test_torch_tp.py``); qwen2.5-3b on (4, 2) also through the
  kernel path (``use_pallas_decode``: ``decode_attention``'s partial
  mode, its plain version on the CPU).  The split cache saved as a
  sharded checkpoint holds the whole cache.
* Checkpoints of a ZeRO run (qwen2.5-3b): the (2, 4) file at step 0
  equals the single-shard run's bit for bit under ``np.load``; the file
  saved after 2 steps restores on (2, 4) bit for bit and on (4, 2) into
  blocks equal to ``rank_block`` of its whole leaves; 2 steps, a save, a
  restore and 1 more step equal 3 straight steps bit for bit.

Tests without a spawn hold ``decode_attention``'s partial mode (plain
version) to a dense softmax, empty windows included, and the refusals.
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
from repro.launch.steps import make_train_step as jax_train_step
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jax_adamw_init

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESHES = ((2, 4), (4, 2), (8, 1))
TOL = 1e-5
B, S, STEPS, LR = 4, 8, 3, 1e-2
CP_LEN, CP_PROMPT, CP_DECODE = 16, 3, 4
ZERO_ARCHS = {"qwen2.5-3b": {},
              "granite-moe-3b-a800m": {"n_experts": 5},
              "jamba-1.5-large-398b": {"n_layers": 8, "n_experts": 5}}
CP_ARCHS = {"qwen2.5-3b": {}, "jamba-1.5-large-398b": {"n_layers": 8}}
REF_ZERO = "qwen2.5-3b (2, 4)"


def _jcfg(arch, replace):
    return dataclasses.replace(jcfgs.smoke_config(arch), **replace)


def _jparams(arch, replace, seed):
    return jax.tree.map(np.asarray, jmodels.init_params(
        _jcfg(arch, replace), jax.random.PRNGKey(seed)))


def _cases() -> dict:
    cases = {}
    for i, (arch, rep) in enumerate(ZERO_ARCHS.items()):
        for mesh in MESHES[:2]:
            name = f"{arch} {mesh}"
            cases[f"zero {name}"] = {
                "kind": "zero", "arch": arch, "replace": rep, "mesh": mesh,
                "seed": 200 + i,
                "params": _jparams(arch, rep, i) if name == REF_ZERO
                else None}
    for i, (arch, rep) in enumerate(CP_ARCHS.items()):
        params = _jparams(arch, rep, 10 + i)
        for mesh in (MESHES[1], MESHES[2]):
            cases[f"cp {arch} {mesh}"] = {
                "kind": "cp", "arch": arch, "replace": rep, "mesh": mesh,
                "seed": 300 + i, "params": params}
        if arch == "qwen2.5-3b":
            cases[f"cp {arch} {MESHES[1]} kernel path"] = dict(
                cases[f"cp {arch} {MESHES[1]}"],
                replace=dict(rep, use_pallas_decode=True))
    cases["ckpt qwen2.5-3b"] = {"kind": "ckpt", "arch": "qwen2.5-3b",
                                "replace": {}, "meshes": MESHES[:2],
                                "seed": 400, "params": None}
    return cases


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """(inputs, [rank results]) of one 8-rank gloo run."""
    folder = tmp_path_factory.mktemp("zero_cp")
    inputs = {"cases": _cases(), "meshes": MESHES}
    (folder / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_zero_cp_worker.py"),
         str(r), str(WORLD), str(folder)], env=env, cwd=ROOT,
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
ZERO = [n for n in CASES if n.startswith("zero ")]
CP = [n for n in CASES if n.startswith("cp ")]
CKPT_FLAGS = ("step 0 file bitwise", "restored bitwise", "resume bitwise",
              "other mesh bitwise", "other mesh is not this one")


@pytest.mark.parametrize("name", ZERO)
def test_zero_matches_single_shard_and_plain(gloo, name):
    """Every rank's ZeRO-1 steps within 1e-5 of the same mesh without
    ZeRO and of the single-shard steps; its moments 1/n_data of the
    non-ZeRO blocks' bytes; the grads reduce-scattered and the params
    all-gathered."""
    inputs, ranks = gloo
    n_data = inputs["cases"][name]["mesh"][0]
    for r, res in enumerate(ranks):
        rec = res[name]
        bad = {k: v for k, v in rec["err"].items()
               if not v <= (1e-6 if k in ("global_norm", "norm0 vs single")
                            else TOL)}
        assert not bad, (name, r, bad)
        assert all(rec["ok"].values()), (name, r, rec["ok"])
        zero_bytes, plain_bytes = rec["moment_bytes"]
        assert zero_bytes < plain_bytes, (name, r, n_data)
        assert rec["calls"]["reduce_scatter"] > 0
        assert rec["calls"]["all_gather"] > 0


def _batch(cfg, seed):
    from repro_torch.models import random_batch
    batch = random_batch(cfg, B, S, seed=seed, embed_dtype=torch.float32,
                         device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_zero_matches_reference(gloo):
    """qwen2.5-3b's ZeRO-1 steps on (2, 4) on the reference's weights
    against the reference's jitted train step on one device."""
    inputs, ranks = gloo
    case = inputs["cases"][f"zero {REF_ZERO}"]
    cfg = _jcfg(case["arch"], case["replace"])
    params = jax.tree.map(jnp.asarray, case["params"])
    state = jax_adamw_init(params)
    step = jax.jit(jax_train_step(cfg, jmodels.Parallel(), JAdamW(lr=LR)))
    want = []
    for i in range(STEPS):
        params, state, met = step(params, state, _batch(cfg, case["seed"] + i))
        want.append(float(met["loss"]))
    for res in ranks:
        np.testing.assert_allclose(res[f"zero {REF_ZERO}"]["losses"], want,
                                   rtol=1e-5)


@pytest.mark.parametrize("name", CP)
def test_context_parallel_matches_single_shard(gloo, name):
    """Batch-1 prefill and decode on a sequence-split cache: every rank's
    logits and cache blocks within 1e-5 of the single-shard run's, the
    KV cache's sequence cut by the data ranks, and the sharded
    checkpoint of the cache holding the whole cache."""
    _, ranks = gloo
    for r, res in enumerate(ranks):
        rec = res[name]
        bad = {k: v for k, v in rec["err"].items() if not v <= TOL}
        assert not bad, (name, r, bad)
        assert all(rec["ok"].values()), (name, r, rec["ok"])


@pytest.mark.parametrize("name", CP)
def test_context_parallel_matches_reference(gloo, name):
    """The context-parallel logits on the reference's weights against the
    reference's ``prefill`` and ``decode_step`` fed the same tokens."""
    inputs, ranks = gloo
    case = inputs["cases"][name]
    cfg = _jcfg(case["arch"], case["replace"])
    params = jax.tree.map(jnp.asarray, case["params"])
    rec = ranks[0][name]
    logits, cache = jmodels.prefill(cfg, params,
                                    {"tokens": jnp.asarray(rec["prompt"])},
                                    CP_LEN)
    want = [np.asarray(logits)]
    pos = jnp.full((1,), CP_PROMPT, dtype=jnp.int32)
    for i in range(CP_DECODE):
        lg, cache = jmodels.decode_step(cfg, params, cache,
                                        jnp.asarray(rec["tokens"][i]), pos)
        want.append(np.asarray(lg))
        pos = pos + 1
    for res in ranks:
        for got, w in zip(res[name]["logits"], want):
            np.testing.assert_allclose(got, w, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("flag", CKPT_FLAGS)
def test_sharded_checkpoints(gloo, flag):
    _, ranks = gloo
    for r, res in enumerate(ranks):
        assert res["ckpt qwen2.5-3b"]["ok"][flag], (flag, r)


# --------------------------------------------------------------------- #
# No spawn: the partial mode's plain version, the refusals
# --------------------------------------------------------------------- #


def _dense(q, k, v, lo, hi):
    """Softmax attention of q over rows [lo, hi] of k, v (f64)."""
    hd = q.shape[-1]
    sco = torch.einsum("bhgd,bhsd->bhgs", q.double(),
                       k[:, :, lo:hi + 1].double()) * hd ** -0.5
    return torch.einsum("bhgs,bhsd->bhgd", torch.softmax(sco, -1),
                        v[:, :, lo:hi + 1].double()), torch.logsumexp(sco, -1)


@pytest.mark.parametrize("hd,g", [(16, 1), (64, 4)])
def test_partial_plain_against_dense_softmax(hd, g):
    """``decode_attention_partial_plain`` against a dense softmax over the
    visible rows, an empty window (pos = -1) giving out = 0 and
    lse = -inf; two blocks' partials combined as ``attention._combine``
    combines the ranks' equal the whole cache's attention."""
    from repro_torch.kernels.decode_attn import decode_attention_partial_plain
    gen = torch.Generator().manual_seed(hd + g)
    b, hkv, s = 3, 2, 24
    q = torch.randn(b, hkv, g, hd, generator=gen)
    k = torch.randn(b, hkv, s, hd, generator=gen)
    v = torch.randn(b, hkv, s, hd, generator=gen)
    pos = torch.tensor([7, -1, 23], dtype=torch.int32)
    out, lse = decode_attention_partial_plain(q, k, v, pos)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:-1]
    for i in (0, 2):
        want, want_lse = _dense(q[i:i + 1], k[i:i + 1], v[i:i + 1], 0,
                                int(pos[i]))
        torch.testing.assert_close(out[i:i + 1].double(), want, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(lse[i:i + 1].double(), want_lse,
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert bool(torch.isneginf(lse[1]).all())
    # Two blocks of 12 rows, each with its local positions.
    full, _ = _dense(q, k, v, 0, 23)
    parts = [decode_attention_partial_plain(
        q, k[:, :, s0:s0 + 12], v[:, :, s0:s0 + 12],
        torch.full((b,), 23 - s0, dtype=torch.int32).clamp(-1, 11))
        for s0 in (0, 12)]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(p[1] - m)[..., None] for p in parts]
    got = (parts[0][0] * w[0] + parts[1][0] * w[1]) / (w[0] + w[1])
    torch.testing.assert_close(got.double(), full, rtol=1e-5, atol=1e-5)


def test_partial_meta_and_counting():
    """The partial mode on ``meta`` returns empty f32 results and reports
    its call to a dry-run count with the rows it reads."""
    from repro_torch import counting
    from repro_torch.kernels import decode_attn
    from repro_torch.launch import op_analysis
    q = torch.empty((1, 1, 4, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 1, 256, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    cost, (out, lse) = op_analysis.analyze(
        decode_attn.decode_attention_partial, q, k, k, pos)
    assert out.shape == (1, 1, 4, 128) and out.dtype == torch.float32
    assert lse.shape == (1, 1, 4) and lse.dtype == torch.float32
    assert cost.kernel_counts == {"decode_attention": 1}
    assert cost.flops == 4 * 4 * 128 * 256
    assert cost.bytes_accessed == 2 * 256 * 128 * 2 + 4 * 128 * (2 + 4) \
        + 4 * 4 + 4
    assert not counting.active()


def test_context_refusals():
    """Context parallelism needs a whole batch; ``init_cache`` refuses a
    ``Parallel`` whose ``context`` disagrees with the rules' split."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Parallel, init_cache
    with pytest.raises(ValueError, match="batch_split=False"):
        Parallel(context=True)

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 1}
        size = 4

        def coordinate(self):
            return {"data": 0, "model": 0}

    cfg = smoke_config("qwen2.5-3b")
    par = Parallel(mesh=Mesh(), batch_split=False, context=True)
    cache = init_cache(cfg, 1, 16, "meta", par)
    assert cache["layers"][0]["k"].shape == (1, 4, cfg.n_kv_heads,
                                             cfg.head_dim)
    with pytest.raises(ValueError, match="context"):
        init_cache(cfg, 1, 16, "meta", Parallel(mesh=Mesh(),
                                                batch_split=False))
    with pytest.raises(ValueError, match="context"):
        init_cache(cfg, 1, 18, "meta", par)
