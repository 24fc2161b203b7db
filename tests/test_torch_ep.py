"""Expert parallelism of the port over gloo, against the reference.

One module fixture starts 8 ranks (``tests/torch_ep_worker.py``, one
process each, a gloo group through ``file://`` under the test's
temporary folder, so xdist workers never share a port) that run every
case in that one spawn, on a (2, 4) ("data", "model") mesh:

(a) deepseek-moe-16b's smoke MoE block (8 experts, top-4 of the smoke
    config, one shared expert) at the default capacity, under "ep"
    (tokens split by batch over data and by sequence over model) and
    "ep_rep" (batch over data, tokens replicated over model): each
    rank's block of the output equals the reference's
    ``moe_apply_local`` on that rank's slice (each shard sizes its
    capacity from its own tokens, as the reference's body does), ``aux``
    is the reference's aux of the first slice (``shard_map`` with
    ``check_vma=False`` keeps device 0's block of a ``P()`` output), and
    the router's grad of the aux term is the mean over the slices of the
    reference's (what ``jax.grad`` through that ``shard_map`` gives);
(b) granite-moe-3b-a800m's smoke block with ``moe_slotting``, once with
    6 experts padded to 8 virtual buckets and once with 2 experts in 2
    fragments each (4 buckets): "auto" resolves to "ep" by the virtual
    bucket count (6 and 2 do not divide 4), and (a)'s checks hold;
(c) (a) at ``capacity_factor=8.0`` (no copy dropped): outputs and the
    grads of sum(y * cot) for w_gate, w_up, w_down, router and the
    shared expert equal the port's single-shard ones;
(d) ``loss_fn(cfg, params, batch, par)`` on deepseek's smoke model at
    (4, 32): bitwise the same on every rank, within 2e-2 of the
    single-shard loss (the reference's own bound for its distributed
    loss, ``tests/test_launch.py``); at capacity 8 its cross-entropy
    within 1e-5 of the single-shard one, and the loss within 1e-5 of
    that cross-entropy plus the aux of the first rank's slices (the aux
    rule of (a), which the single-shard loss does not follow);
(e) one ``make_train_step`` step at capacity 8 under "ep_rep" on a
    (1, 8) mesh, where the first rank's tokens are all the tokens and
    its aux is the global one: the grads it takes and its loss and grad
    norm within 1e-5 of the single-shard step's, its params bitwise the
    same on every rank and within 1e-5 of the single-shard step's
    wherever the grad is at least 1e-3 of its leaf's largest.  (AdamW's
    first step moves a weight by lr * g / (|g| + eps): where |g| nears
    eps, a rounding of g moves the weight by up to 2 lr.  On this input
    the grads agree within 1.4e-7, and embedding weights with small
    grads still differ by 2.3e-6 after the step.)

Tolerances: "within r" is max|got - want| <= r * max|want| per tensor.
1e-5 in f32 covers summation order: the all-reduce adds the ranks'
partial outputs in another order than one device's combine, and
``matmul`` blocks rows differently for a rank's slice of the tokens
than for all of them (the reference's own EP gap to single-shard math
is up to 4.5e-7).  At the default capacity "ep_rep" is not held to the
single-shard output: each data shard sizes its capacity from its own 64
tokens and drops other copies than one shard of 128 does (on this input
the outputs differ by 8 % of their largest), as the reference's body
does; its blocks are held to the per-slice math instead.

A ``slow`` test also runs the reference's ``_apply_moe`` under
``shard_map`` on 8 forced host devices (with ``jax.set_mesh``: ``with
mesh:`` raises in ``jax.grad`` under jax 0.9.0) and holds the gloo
run's outputs and grads to it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jcfgs
import repro.models as jmodels
from repro.models import moe as jmoe

ROOT = Path(__file__).resolve().parents[1]
WORLD, DATA, MODEL = 8, 2, 4
B, S = 4, 32
DEEPSEEK, GRANITE = "deepseek-moe-16b", "granite-moe-3b-a800m"
CAP8 = {"capacity_factor": 8.0}
LAYER_CASES = {
    "deepseek": (DEEPSEEK, {}, ("ep", "ep_rep")),
    "deepseek_cap8": (DEEPSEEK, CAP8, ("ep", "ep_rep")),
    "granite_pad": (GRANITE, {"n_experts": 6, "moe_slotting": True,
                              "moe_ep_slots": MODEL}, ("auto",)),
    "granite_frag": (GRANITE, {"n_experts": 2, "top_k": 2,
                               "moe_slotting": True, "moe_ep_slots": MODEL},
                     ("auto",)),
}


def _jcfg(arch, replace):
    return dataclasses.replace(jcfgs.smoke_config(arch), **replace)


def _np_params(cfg):
    return jax.tree.map(np.asarray, jmodels.init_params(cfg, jax.random.PRNGKey(0)))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _inputs() -> dict:
    layers = {}
    for i, (name, (arch, rep, modes)) in enumerate(LAYER_CASES.items()):
        cfg = _jcfg(arch, rep)
        rng = np.random.default_rng(10 + i)
        layers[name] = {
            "arch": arch, "replace": rep, "modes": modes,
            "params": _np_params(cfg),
            "x": rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32),
            "cot": rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)}
    first = (slice(0, B // DATA), slice(0, S // MODEL))     # rank 0, "ep"
    loss = {}
    for name, rep in (("default", {}), ("cap8", CAP8)):
        cfg = _jcfg(DEEPSEEK, rep)
        loss[name] = {"arch": DEEPSEEK, "replace": rep,
                      "params": _np_params(cfg), "batch": _batch(cfg, 3),
                      "first_block": first}
    cfg = _jcfg(DEEPSEEK, CAP8)
    train = {"arch": DEEPSEEK, "replace": CAP8, "params": _np_params(cfg),
             "batch": _batch(cfg, 4), "lr": 1e-2}
    return {"layers": layers, "loss": loss, "train": train}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """(inputs, [rank results]) of one 8-rank gloo run."""
    folder = tmp_path_factory.mktemp("ep")
    inputs = _inputs()
    (folder / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_ep_worker.py"), str(r),
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
    return folder, inputs, [pickle.loads((folder / f"rank{r}.pkl").read_bytes())
                            for r in range(WORLD)]


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


def _block(rank, mode):
    """This rank's (batch, sequence) slices of the tokens under ``mode``."""
    d, m = divmod(rank, MODEL)
    rows = slice(d * B // DATA, (d + 1) * B // DATA)
    if mode == "ep":
        return rows, slice(m * S // MODEL, (m + 1) * S // MODEL)
    return rows, slice(None)


def _reference_local(name, case, x):
    cfg = _jcfg(*LAYER_CASES[name][:2])
    layer = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         case["params"]["units"]["b0"]["ffn"])
    y, aux = jmoe.moe_apply_local(cfg, layer, jnp.asarray(x), jnp.float32)
    return np.asarray(y), jax.tree.map(np.asarray, aux)


BLOCK_CASES = [(n, m) for n, (_, _, modes) in LAYER_CASES.items()
               for m in modes]


def test_mesh_is_data_major(gloo):
    _, _, ranks = gloo
    for r, res in enumerate(ranks):
        assert res["coordinate"] == {"data": r // MODEL, "model": r % MODEL}
        assert res["group_sizes"] == {"data": DATA, "model": MODEL}


@pytest.mark.parametrize("name,mode", BLOCK_CASES)
def test_blocks_match_reference_slices(gloo, name, mode):
    """Each rank's block of the assembled output is the reference's
    single-shard math on that rank's tokens, and the output is the same
    on every rank."""
    _, inputs, ranks = gloo
    case = inputs["layers"][name]
    resolved = ranks[0]["layers"][name]["resolved"] if mode == "auto" else mode
    assert resolved in ("ep", "ep_rep")
    got = ranks[0]["layers"][name][mode]["y"]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["layers"][name][mode]["y"], got)
    for r in range(WORLD):
        rows, seq = _block(r, resolved)
        want, _ = _reference_local(name, case, case["x"][rows, seq])
        _close(got[rows, seq], want, 1e-5, f"{name} {mode} rank {r}")


@pytest.mark.parametrize("name,mode", BLOCK_CASES)
def test_aux_is_the_first_slices(gloo, name, mode):
    _, inputs, ranks = gloo
    case = inputs["layers"][name]
    resolved = ranks[0]["layers"][name]["resolved"] if mode == "auto" else mode
    rows, seq = _block(0, resolved)
    _, want = _reference_local(name, case, case["x"][rows, seq])
    for res in ranks:
        aux = res["layers"][name][mode]["aux"]
        for k in want:
            _close(aux[k], want[k], 1e-5, f"{name} {mode} aux {k}")


@pytest.mark.parametrize("mode", ["ep", "ep_rep"])
def test_aux_grad_is_the_mean_over_slices(gloo, mode):
    """The router's grad of lb + 1e-3 z is the mean over the 8 slices of
    the reference's local grads (``jax.grad`` through the reference's
    ``_apply_moe`` under ``shard_map`` gives exactly that mean, while its
    value is the first slice's)."""
    _, inputs, ranks = gloo
    case = inputs["layers"]["deepseek"]
    cfg = _jcfg(DEEPSEEK, {})
    layer = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         case["params"]["units"]["b0"]["ffn"])

    def term(router, xs):
        _, aux = jmoe.moe_apply_local(cfg, dict(layer, router=router),
                                      jnp.asarray(xs), jnp.float32)
        return aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"]
    grad = jax.grad(term)
    want = sum(np.asarray(grad(layer["router"], case["x"][_block(r, mode)]))
               for r in range(WORLD)) / WORLD
    for res in ranks:
        _close(res["layers"]["deepseek"][mode]["aux_grad"], want, 1e-5, mode)


@pytest.mark.parametrize("name", ["granite_pad", "granite_frag"])
def test_slotting_resolves_by_virtual_buckets(gloo, name):
    """6 or 2 experts do not divide the model axis of 4; their virtual
    buckets (8, 4) do, so "auto" is "ep" (sequence 32 divides 4)."""
    _, _, ranks = gloo
    arch, rep, _ = LAYER_CASES[name]
    assert rep["n_experts"] % MODEL
    assert all(res["layers"][name]["resolved"] == "ep" for res in ranks)


def test_replicated_ep_matches_single_shard_reference(gloo):
    """At capacity 8 (no drops) "ep_rep" assembled is the reference's
    single-shard output."""
    _, inputs, ranks = gloo
    case = inputs["layers"]["deepseek_cap8"]
    want, _ = _reference_local("deepseek_cap8", case, case["x"])
    _close(ranks[0]["layers"]["deepseek_cap8"]["ep_rep"]["y"], want, 1e-5)


@pytest.mark.parametrize("mode", ["ep", "ep_rep"])
def test_capacity8_outputs_and_grads_match_single_shard(gloo, mode):
    _, _, ranks = gloo
    for r, res in enumerate(ranks):
        got, want = res["layers"]["deepseek_cap8"][mode], \
            res["layers"]["deepseek_cap8"]["local"]
        _close(got["y"], want["y"], 1e-5, f"{mode} y rank {r}")
        assert set(got["grads"]) == set(want["grads"]) >= {
            "w_gate", "w_up", "w_down", "router", "shared/w_gate"}
        for k in want["grads"]:
            _close(got["grads"][k], want["grads"][k], 1e-5,
                   f"{mode} grad {k} rank {r}")


@pytest.mark.parametrize("name", ["default", "cap8"])
def test_sharded_loss(gloo, name):
    _, _, ranks = gloo
    got = [res["loss"][name] for res in ranks]
    for res in got[1:]:
        assert res["loss"].tobytes() == got[0]["loss"].tobytes()
    loss, single = float(got[0]["loss"]), float(got[0]["single"])
    assert abs(loss - single) / abs(single) < 2e-2, (loss, single)
    if name == "cap8":
        _close(got[0]["ce"], got[0]["single_ce"], 1e-5, "ce")
        _close(loss, float(got[0]["single_ce"]) + 0.01 * got[0]["first_aux"],
               1e-5, "loss")


def test_train_step_matches_single_shard(gloo):
    _, _, ranks = gloo
    got, want = ranks[0]["train"]["sharded"], ranks[0]["train"]["single"]
    for k in ("loss", "ce", "aux", "grad_norm"):
        _close(got["metrics"][k], want["metrics"][k], 1e-5, k)
    assert len(got["params"]) == len(want["params"]) == len(want["grads"])
    for i, (a, b, ga, g) in enumerate(zip(got["params"], want["params"],
                                          got["grads"], want["grads"])):
        _close(ga, g, 1e-5, f"grad leaf {i}")
        flat = np.abs(g) >= 1e-3 * np.abs(g).max()
        _close(a[flat], b[flat], 1e-5, f"param leaf {i}")
    for res in ranks[1:]:
        for a, b in zip(res["train"]["sharded"]["params"], got["params"]):
            np.testing.assert_array_equal(a, b)


def test_collectives_were_counted(gloo):
    _, _, ranks = gloo
    for res in ranks:
        assert min(res["calls"][k] for k in ("all_to_all", "all_reduce",
                                             "all_gather")) > 0, res["calls"]


@pytest.fixture(scope="module")
def fake(gloo):
    """(d)'s loss and (e)'s step traced on ``meta`` as rank 0 of a fake
    group of 8 ranks (``torch_ep_worker.py fake``)."""
    folder, _, _ = gloo
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_ep_worker.py"), "fake",
         str(WORLD), str(folder)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return pickle.loads((folder / "fake.pkl").read_bytes())


@pytest.mark.parametrize("case", ["default", "cap8", "train"])
def test_fake_group_counts_rank0s_collectives(gloo, fake, case):
    """Rank 0 on a fake group of 8 ranks makes the collective calls of
    rank 0 of the gloo run (op, result bytes, group size), for the
    sharded loss (d) and the sharded train step with its backward (e);
    ``op_analysis`` prices them as ``collective_stats`` prices the gloo
    rank's records.  The calls are compared as a sorted list: autograd
    runs independent branches of the backward (the grads of different
    leaves) in another order on ``meta`` than on the CPU."""
    from repro_torch.launch.roofline import collective_stats
    _, _, ranks = gloo
    want = (ranks[0]["train"]["sharded"] if case == "train"
            else ranks[0]["loss"][case])["records"]
    got = fake[case]
    def key(rec):
        return rec["op"], rec["result_bytes"], rec["group_size"]
    assert want and sorted(got["records"], key=key) == sorted(want, key=key)
    stats = collective_stats(want, WORLD)
    assert got["cost"]["collective_counts"] == stats.counts
    assert got["cost"]["collective_bytes"] == stats.bytes_per_chip


_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import smoke_config
from repro.models import Parallel
from repro.models.model import _apply_moe

folder = sys.argv[1]
inputs = pickle.load(open(os.path.join(folder, "inputs.pkl"), "rb"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for name in ("deepseek", "deepseek_cap8"):
    case = inputs["layers"][name]
    cfg = dataclasses.replace(smoke_config(case["arch"]), **case["replace"])
    layer = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         case["params"]["units"]["b0"]["ffn"])
    x, cot = jnp.asarray(case["x"]), jnp.asarray(case["cot"])
    for mode in ("ep", "ep_rep"):
        par = Parallel(mesh=mesh, moe_mode=mode)

        def f(p):
            y, _ = _apply_moe(cfg, p, x, par, jnp.float32)
            return jnp.sum(y * cot), y

        def term(router):
            _, aux = _apply_moe(cfg, dict(layer, router=router), x, par,
                                jnp.float32)
            return aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"]

        with jax.set_mesh(mesh):
            (_, y), g = jax.value_and_grad(f, has_aux=True)(layer)
            aux_grad = jax.grad(term)(layer["router"])
        grads = {k: np.asarray(g[k]) for k in ("w_gate", "w_up", "w_down",
                                               "router")}
        grads.update({"shared/" + k: np.asarray(v)
                      for k, v in g["shared"].items()})
        out[name, mode] = {"y": np.asarray(y), "grads": grads,
                           "aux_grad": np.asarray(aux_grad)}
pickle.dump(out, open(os.path.join(folder, "reference.pkl"), "wb"))
"""


@pytest.mark.slow
def test_reference_shard_map_matches_gloo(gloo):
    """The reference's EP under shard_map on 8 host devices against the
    port's 8 gloo ranks: outputs, the grads of sum(y * cot) and the
    router's grad of the aux term within 1e-5 (summation order on both
    sides)."""
    folder, _, ranks = gloo
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(folder)], capture_output=True,
        text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    ref = pickle.loads((folder / "reference.pkl").read_bytes())
    for (name, mode), want in ref.items():
        got = ranks[0]["layers"][name][mode]
        _close(got["y"], want["y"], 1e-5, f"{name} {mode} y")
        for k, g in want["grads"].items():
            _close(got["grads"][k], g, 1e-5, f"{name} {mode} grad {k}")
        _close(got["aux_grad"], want["aux_grad"], 1e-5, f"{name} {mode} aux")
    print(json.dumps({f"{n} {m}": float(np.abs(w["y"]).sum())
                      for (n, m), w in ref.items()}))
