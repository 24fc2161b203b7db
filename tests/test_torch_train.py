"""The port's training path against the reference's, on the CPU.

``loss_fn`` and every grad against ``jax.value_and_grad(repro.models
.loss_fn)`` for the smoke configs of four architectures (f32 compute,
B = 2, S = 16, weights carried with ``params_from_jax``; grads are
carried back the same way, since they have the parameters' structure):
the loss within rtol 1e-6 and each grad leaf within 1e-5 of its largest
value (summation order only: measured 1.0e-6).  ``remat="unit"`` equals
``"none"`` bit for bit (the recompute runs the same operations).  Three
steps of ``make_train_step`` against the reference's jitted
``make_train_step`` (``micro_batches`` 1 and 2, lr 1e-2 on a cosine
schedule): losses within rtol 1e-6; mu within atol 1e-7 and nu within
1e-9 (measured 6.5e-9 and 4.7e-10); params within atol 2e-5, rtol 1e-4
(measured 2.4e-6: an element whose grad is a rounding away from zero
moves by another fraction of the learning rate).  ``count`` equal.
The trainer (``launch.train.main``) lowers the loss, and a run
interrupted by ``--simulate-failure`` in a subprocess (exit 42) and
resumed from its checkpoint gives the uninterrupted run's losses bit for
bit.  ``gmm``'s autograd Function on CPU tensors against autograd
through ``gmm_plain``.

The same comparisons at a bfloat16 compute dtype (the dtype of the
full-width run on the card; f32 master weights), for the MoE smoke
configs of llama-moe-3.5b and granite-moe-3b-a800m.  The two sides round
the hidden state apart by up to one bf16 step (2^-8 relative), so
nothing is held elementwise at f32 tolerances: the loss within rtol 1e-4
(measured 2.2e-5) and each grad leaf within 3e-2 of its largest value
(measured 1.5e-2).  deepseek-moe-16b's smoke model is left out here: one
of its token copies sits 1.4e-5 from a tie in router probability, and a
bf16 step of the hidden state routes it to another expert on one side.
Three bf16 steps of ``make_train_step`` (``micro_batches`` 1 and 2):
loss and ce within rtol 2e-4 (measured 7.9e-5), aux within 1e-3 (4.5e-4),
the grad norm within 2e-3 (5.9e-4); the whole tree of parameter updates
within 0.1 of its norm (measured 0.052: AdamW moves a grad that rounds
across zero by a full step the other way), mu and nu within 0.025
(0.011).  Six steps of the full-width run's schedule (lr 3e-4, cosine
with warmup 2) on ``SyntheticTokens`` batches: every loss within rtol
1e-4 of the reference's (measured 3.0e-5).
"""
import dataclasses
import os
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
import repro_torch.configs as tcfgs
import repro_torch.models as tmodels
from repro.launch.steps import make_train_step as jax_train_step
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticTokens, make_batch
from repro_torch.kernels import moe_gmm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Parallel
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama-moe-3.5b", "granite-moe-3b-a800m", "deepseek-moe-16b",
         "smollm-135m"]
BF16_ARCHS = ["llama-moe-3.5b", "granite-moe-3b-a800m"]


def _batch(cfg, b=2, s=16, seed=1, labels="random"):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32) \
        if labels == "random" else toks.copy()
    return {"tokens": toks, "labels": lab}


def _as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _carried(cfg, jtree):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jtree), "cpu")


def _port_value_and_grad(cfg, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = tmodels.loss_fn(cfg, live, _as_torch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _assert_leaves_close(got, want, what, **tol):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    assert tc.compute_dtype == "float32" and tc.remat == "unit"
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    batch = _batch(jc)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(jc, p, _as_jax(batch)), has_aux=True)(jparams)
    loss, met, grads = _port_value_and_grad(tc, _carried(tc, jparams), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-6, atol=1e-7)
    want = tree_leaves(_carried(tc, jgrads))
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        scale = float(b.abs().max()) or 1.0
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=1e-5, err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_unit_remat_equals_no_remat(arch):
    cfg = tcfgs.smoke_config(arch)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 cast=False)
    batch = _batch(cfg, seed=3)
    runs = [_port_value_and_grad(dataclasses.replace(cfg, remat=r), params,
                                 batch) for r in ("unit", "none")]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


def test_init_params_uncast_keeps_param_dtype():
    cfg = dataclasses.replace(tcfgs.smoke_config("granite-moe-3b-a800m"),
                              compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    master = tmodels.init_params(cfg, gen, "cpu", cast=False)
    assert all(p.dtype == torch.float32 for p in tree_leaves(master))
    cast = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = tmodels.cast_for_compute(cfg, tree_map(torch.clone, master))
    for a, b in zip(tree_leaves(cast), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_train_steps_match_reference(micro_batches):
    arch = "granite-moe-3b-a800m"
    jc, tc = jcfgs.smoke_config(arch), tcfgs.smoke_config(arch)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    params = _carried(tc, jparams)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)
    jstep = jax.jit(jax_train_step(jc, jmodels.Parallel(), JAdamW(lr=1e-2),
                                   jax_cosine(1, 3), micro_batches))
    step = make_train_step(tc, Parallel(), AdamWConfig(lr=1e-2),
                           cosine_schedule(1, 3),
                           micro_batches)
    for i in range(3):
        batch = _batch(jc, b=4, seed=10 + i, labels="tokens")
        jparams, jstate, jmet = jstep(jparams, jstate, _as_jax(batch))
        params, state, met = step(params, state, _as_torch(batch))
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
    assert int(state["count"]) == int(jstate["count"]) == 3
    _assert_leaves_close(params, _carried(tc, jparams), "params", atol=2e-5,
                         rtol=1e-4)
    _assert_leaves_close(state["mu"], _carried(tc, jstate["mu"]), "mu",
                         atol=1e-7, rtol=1e-4)
    _assert_leaves_close(state["nu"], _carried(tc, jstate["nu"]), "nu",
                         atol=1e-9, rtol=1e-4)


def _bf16_cfgs(arch):
    return [dataclasses.replace(c.smoke_config(arch), compute_dtype="bfloat16")
            for c in (jcfgs, tcfgs)]


def _tree_rel_err(got, want, start=None):
    """||got - want|| / ||want|| over a whole tree (of ``x - start`` where
    ``start`` is given)."""
    got, want = tree_leaves(got), tree_leaves(want)
    if start is not None:
        got = [a - s for a, s in zip(got, tree_leaves(start))]
        want = [b - s for b, s in zip(want, tree_leaves(start))]
    num = sum(float(torch.sum((a - b).double() ** 2)) for a, b in zip(got, want))
    den = sum(float(torch.sum(b.double() ** 2)) for b in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    jc, tc = _bf16_cfgs(arch)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    batch = _batch(jc)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodels.loss_fn(jc, p, _as_jax(batch)), has_aux=True)(jparams)
    loss, met, grads = _port_value_and_grad(tc, _carried(tc, jparams), batch)
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                      (met["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    want = tree_leaves(_carried(tc, jgrads))
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        assert a.dtype == torch.float32
        scale = float(b.abs().max()) or 1.0
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   atol=3e-2, err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_bf16_train_steps_match_reference(micro_batches):
    jc, tc = _bf16_cfgs("granite-moe-3b-a800m")
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    start = _carried(tc, jparams)
    params = tree_map(torch.clone, start)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)
    jstep = jax.jit(jax_train_step(jc, jmodels.Parallel(), JAdamW(lr=1e-2),
                                   jax_cosine(1, 3), micro_batches))
    step = make_train_step(tc, Parallel(), AdamWConfig(lr=1e-2),
                           cosine_schedule(1, 3),
                           micro_batches)
    tols = {"loss": 2e-4, "ce": 2e-4, "aux": 1e-3, "grad_norm": 2e-3}
    for i in range(3):
        batch = _batch(jc, b=4, seed=10 + i, labels="tokens")
        jparams, jstate, jmet = jstep(jparams, jstate, _as_jax(batch))
        params, state, met = step(params, state, _as_torch(batch))
        for key, rtol in tols.items():
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=rtol, err_msg=f"step {i} {key}")
    assert int(state["count"]) == int(jstate["count"]) == 3
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    assert _tree_rel_err(params, _carried(tc, jparams), start) < 0.1
    for key in ("mu", "nu"):
        assert _tree_rel_err(state[key], _carried(tc, jstate[key])) < 0.025


def test_bf16_full_width_schedule_matches_reference():
    """Six steps of the full-width run's schedule (phase 15c of
    ``chip_smoke.py``: AdamW at lr 3e-4, cosine with warmup 2 over 6
    steps, ``SyntheticTokens`` batches whose labels are the tokens) on
    granite-moe-3b-a800m's smoke model in bf16: the port's loss curve is
    the reference's.  Run with ``-s`` to see both curves."""
    jc, tc = _bf16_cfgs("granite-moe-3b-a800m")
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    params = _carried(tc, jparams)
    jstate, state = jax_adamw_init(jparams), adamw_init(params)
    jstep = jax.jit(jax_train_step(jc, jmodels.Parallel(), JAdamW(lr=3e-4),
                                   jax_cosine(2, 6)))
    step = make_train_step(tc, Parallel(), AdamWConfig(lr=3e-4),
                           cosine_schedule(2, 6))
    data = SyntheticTokens(DataConfig(vocab_size=tc.vocab_size, seq_len=64,
                                      global_batch=4, seed=0))
    losses, jlosses = [], []
    for i in range(6):
        batch = make_batch(tc, data, i)
        jparams, jstate, jmet = jstep(jparams, jstate, _as_jax(batch))
        params, state, met = step(params, state, _as_torch(batch))
        losses.append(float(met["loss"]))
        jlosses.append(float(jmet["loss"]))
    print(f"bf16 smoke losses: port {losses}, reference {jlosses}")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_micro_batches_must_divide_the_batch():
    cfg = tcfgs.smoke_config("smollm-135m")
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 cast=False)
    step = make_train_step(cfg, Parallel(), micro_batches=3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        step(params, adamw_init(params), _as_torch(_batch(cfg, b=4)))


def test_train_main_lowers_the_loss(capsys):
    out = ttrain.main(["--smoke", "--device", "cpu", "--steps", "8",
                       "--batch", "2", "--seq", "32", "--log-every", "4"])
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    assert out["final_loss"] == out["losses"][-1] < out["losses"][0]
    assert out["n_params"] == sum(
        p.numel() for p in tree_leaves(tmodels.init_params(
            tcfgs.smoke_config("smollm-135m"), device="cpu")))
    text = capsys.readouterr().out
    assert "[train] smollm-135m-smoke:" in text and "device=cpu" in text
    assert text.count("step ") == 3                  # steps 0, 4 and 7


def test_resume_after_simulated_failure_is_exact(tmp_path):
    """``--simulate-failure 3`` exits 42 after step 3 (checkpoints at 2);
    the re-launch resumes at step 2 and repeats the uninterrupted run's
    losses from there, bit for bit."""
    argv = ["--smoke", "--arch", "granite-moe-3b-a800m", "--device", "cpu",
            "--steps", "5", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path / "ckpt")]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--simulate-failure", "3"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == ttrain.FAILURE_EXIT_CODE, res.stdout + res.stderr
    assert "[failure-sim] hard exit at step 3" in res.stdout
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["manifest.json",
                                                     "step_2.npz"]
    resumed = ttrain.main(argv)
    full = ttrain.main(argv[:-2])
    assert len(resumed["losses"]) == 3 and len(full["losses"]) == 5
    assert resumed["losses"] == full["losses"][2:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_function_grads_equal_autograd_through_plain(dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=gen).to(dtype)
    w = torch.randn(3, 8, 6, generator=gen).to(dtype)
    dy = torch.randn(3, 5, 6, generator=gen).to(dtype)
    got, want = [], []
    for fn, out in ((moe_gmm.gmm, got), (moe_gmm.gmm_plain, want)):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xr, wr)
        out += [y, *torch.autograd.grad(y, (xr, wr), dy)]
    assert type(got[0].grad_fn).__name__ == "GmmFunctionBackward"
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=0, atol=0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype
        torch.testing.assert_close(a, b, **tol)
    with torch.no_grad():                     # serve: no autograd node
        assert moe_gmm.gmm(x.requires_grad_(True), w).grad_fn is None
    assert moe_gmm.gmm(x.detach(), w).grad_fn is None


@pytest.mark.parametrize("slotted", [False, True])
def test_moe_paired_gather_grads_equal_autograd_through_indexing(
        monkeypatch, slotted):
    """The MoE layer's dispatch and combine gathers (``moe._gather``) give
    the grads of autograd through plain indexing, for the canonical stack
    and for an EP-slotted one (2 fragments an expert: K * frag copies a
    token), with dropped copies and unfilled slots (capacity factor 0.5);
    f32, within rtol 1e-6 (the paired gather sums a token's copies in
    another order)."""
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(tcfgs.smoke_config("llama-moe-3.5b"),
                              capacity_factor=0.5, moe_slotting=slotted,
                              moe_ep_slots=16)
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    dy = torch.randn(2, 16, cfg.d_model, generator=gen)

    def grads():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        xr = x.clone().requires_grad_(True)
        y, _ = tmoe.moe_apply_local(cfg, live, xr, torch.float32)
        return [y, *torch.autograd.grad(y, [xr, *tree_leaves(live)], dy)]
    got = grads()
    monkeypatch.setattr(tmoe, "_gather", lambda src, index, valid, *_:
                        src[index] * valid[:, None].to(src.dtype))
    want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
