"""The port's training substrate against the reference's, on the CPU:
``optim`` (AdamW, the schedules), ``data`` (the synthetic token
pipeline) and ``checkpoint`` (the atomic store).

Tolerances: ``SyntheticTokens.batch`` and ``make_batch`` are the same
numpy code, held bitwise.  The schedules are f32 in both packages:
within 2 f32 units in the last place (rtol 2.4e-7; XLA's and PyTorch's
cos, exp and log may round differently).  ``adamw_update`` on the same
f32 numpy trees: the global norm within 1e-6 relative (its partial sums
added in another order), moments and params within rtol 1e-5 and an
atol of 1e-6 (for params: an element whose grad is one rounding away
from zero moves by another fraction of the learning rate 1e-3).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.data as jdata
import repro.optim as joptim
import repro_torch.checkpoint as tckpt
import repro_torch.data as tdata
import repro_torch.optim as toptim
from repro.models.config import ModelConfig as JConfig
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.tree import tree_leaves, tree_map

# --------------------------------------------------------------------- #
# optim: AdamW
# --------------------------------------------------------------------- #


def _trees(seed, grad_scale):
    """A nested params tree (dicts and a list, as the port's) and grads
    of the same structure, numpy f32."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.normal(size=shape).astype(np.float32)
    params = {"embed": leaf(6, 4), "layers": [{"w": leaf(4, 3), "b": leaf(3)},
                                              {"w": leaf(4, 3), "b": leaf(3)}]}
    grads = tree_map(lambda p: (grad_scale * rng.normal(size=p.shape))
                     .astype(np.float32), params)
    return params, grads


def _jax_tree(tree):
    """The same tree with jnp leaves for the reference (``jax.tree``
    flattens dicts in sorted key order, as the port does)."""
    return tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["clip-inactive", "clip-active"])
def test_adamw_update_matches_reference(grad_scale):
    params, grads = _trees(0, grad_scale)
    jcfg, tcfg = joptim.AdamWConfig(lr=1e-3), toptim.AdamWConfig(lr=1e-3)
    jp, jstate = _jax_tree(params), joptim.adamw_init(_jax_tree(params))
    tp = tree_map(torch.from_numpy, tree_map(np.copy, params))
    tstate = toptim.adamw_init(tp)
    sched_j = joptim.cosine_schedule(1, 5)
    sched_t = toptim.cosine_schedule(1, 5)
    for step in range(3):
        g = tree_map(lambda x, s=step: x * (1.0 + 0.5 * s), grads)
        jp, jstate, jn = joptim.adamw_update(jcfg, jp, _jax_tree(g), jstate,
                                             sched_j(jstate["count"]))
        tp, tstate, tn = toptim.adamw_update(
            tcfg, tp, tree_map(torch.from_numpy, g), tstate,
            sched_t(tstate["count"]))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        if grad_scale > 1:
            assert float(tn) > tcfg.grad_clip       # the clip is active
        else:
            assert float(tn) < tcfg.grad_clip
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    assert tstate["count"].dtype == torch.int32
    for name, a, b in (("params", tp, jp), ("mu", tstate["mu"], jstate["mu"]),
                       ("nu", tstate["nu"], jstate["nu"])):
        for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
            assert x.dtype == torch.float32, name
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_global_norm_matches_reference():
    params, _ = _trees(3, 1.0)
    np.testing.assert_allclose(
        float(toptim.global_norm(tree_map(torch.from_numpy, params))),
        float(joptim.global_norm(_jax_tree(params))), rtol=1e-6)
    t = {"a": torch.ones(4), "b": torch.ones(3)}
    assert abs(float(toptim.global_norm(t)) - np.sqrt(7)) < 1e-6


def test_adamw_keeps_each_leafs_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "s": torch.ones(2)}
    g = tree_map(torch.ones_like, p)
    state = toptim.adamw_init(p)
    assert all(m.dtype == torch.float32 for m in tree_leaves(state["mu"]))
    p2, state, _ = toptim.adamw_update(toptim.AdamWConfig(), p, g, state, 1.0)
    assert p2["w"].dtype == torch.bfloat16 and p2["s"].dtype == torch.float32
    assert p2["w"] is p["w"]                   # updated in place


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = toptim.AdamWConfig(lr=0.2, weight_decay=0.0)
    state = toptim.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, gnorm = toptim.adamw_update(cfg, params, grads, state,
                                                   1.0)
    assert float(params["w"].abs().max()) < 0.05
    assert np.isfinite(float(gnorm))


def test_grad_clip_limits_update():
    params = {"w": torch.zeros(3)}
    cfg = toptim.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    state = toptim.adamw_init(params)
    big = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, state2, gnorm = toptim.adamw_update(cfg, params, big, state, 1.0)
    assert float(gnorm) > 1e5
    assert float(state2["mu"]["w"].abs().max()) <= 0.2   # clipped to norm 1


# --------------------------------------------------------------------- #
# optim: schedules
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (10, 100)), ("cosine_schedule", (0, 50, 0.2)),
    ("wsd_schedule", (10, 100)), ("wsd_schedule", (10, 100, 0.2)),
    ("wsd_schedule", (5, 40, 0.3, 0.05))])
def test_schedule_matches_reference(name, args):
    jfn, tfn = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    steps = np.arange(121)
    want = np.array([float(jfn(int(s))) for s in steps], np.float32)
    got = np.array([float(tfn(int(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    # a tensor step (the optimizer's int32 count) gives the same values
    got_t = tfn(torch.arange(121, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got_t, got)


def test_schedules():
    cos = toptim.cosine_schedule(10, 100)
    assert float(cos(0)) == 0.0
    assert abs(float(cos(10)) - 1.0) < 1e-6
    assert float(cos(100)) <= 0.11
    wsd = toptim.wsd_schedule(10, 100, decay_frac=0.2)
    assert abs(float(wsd(50)) - 1.0) < 1e-6
    assert float(wsd(99)) < 0.05
    assert float(wsd(5)) == 0.5


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_synthetic_tokens_bitwise(n_shards):
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    jd = jdata.SyntheticTokens(jdata.DataConfig(**kw))
    td = tdata.SyntheticTokens(tdata.DataConfig(**kw))
    for step in (0, 5):
        for shard in range(n_shards):
            a = jd.batch(step, shard, n_shards)
            b = td.batch(step, shard, n_shards)
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype and b.shape == (8 // n_shards, 16)
    with pytest.raises(ValueError):
        td.batch(0, 0, 3)


@pytest.mark.parametrize("frontend", ["", "vision", "audio"])
def test_make_batch_bitwise(frontend):
    kw = dict(name="a", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
              d_ff=64, vocab_size=64, frontend=frontend)
    dkw = dict(vocab_size=64, seq_len=16, global_batch=4, seed=1)
    jd = jdata.SyntheticTokens(jdata.DataConfig(**dkw))
    td = tdata.SyntheticTokens(tdata.DataConfig(**dkw))
    for step, shard, n in ((0, 0, 1), (2, 1, 2)):
        a = jdata.make_batch(JConfig(**kw), jd, step, shard, n)
        b = tdata.make_batch(TConfig(**kw), td, step, shard, n)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(b[key], a[key])
            assert b[key].dtype == a[key].dtype
    if frontend == "vision":
        n_emb = b["embeds"].shape[1]
        assert (b["labels"][:, :n_emb] == -1).all()
    if frontend == "audio":
        assert "tokens" not in b and (b["labels"] >= 0).all()


def test_data_deterministic_and_shard_disjoint():
    d = tdata.SyntheticTokens(tdata.DataConfig(vocab_size=100, seq_len=16,
                                               global_batch=8))
    a = d.batch(3, shard=0, n_shards=2)
    np.testing.assert_array_equal(a, d.batch(3, shard=0, n_shards=2))
    assert not np.array_equal(a, d.batch(3, shard=1, n_shards=2))
    assert a.shape == (4, 16) and a.min() >= 0 and a.max() < 100


# --------------------------------------------------------------------- #
# checkpoint
# --------------------------------------------------------------------- #


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "layers": [{"b": torch.ones(2, dtype=torch.bfloat16)}],
            "step": torch.zeros((), dtype=torch.int32)}
    for s in [10, 20, 30]:
        tree = {"w": tree["w"] + 1,
                "layers": [{"b": tree["layers"][0]["b"] * 1.5}],
                "step": torch.tensor(s, dtype=torch.int32)}
        mgr.save(s, tree)
    assert tckpt.latest_step(str(tmp_path)) == 30
    assert not os.path.exists(tmp_path / "step_10.npz")     # retention
    step, restored = mgr.restore_latest(tree)
    assert step == 30
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert sorted(restored) == sorted(tree)
    assert isinstance(restored["layers"], list)


def test_checkpoint_files_read_by_the_reference(tmp_path):
    """The port writes the reference's files: its manifest and its
    ``leaf_<i>`` arrays, in the sorted-key order ``jax.tree`` uses."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a": torch.full((4,), 2.0)}
    tckpt.CheckpointManager(str(tmp_path)).save(7, tree)
    assert jckpt.latest_step(str(tmp_path)) == 7
    like = {"w": jnp.zeros((2, 3)), "a": jnp.zeros(4)}
    _, got = jckpt.CheckpointManager(str(tmp_path)).restore_latest(like)
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())


def test_checkpoint_crash_safety(tmp_path):
    """A torn tmp file never corrupts the manifest-listed checkpoint."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    with open(tmp_path / "step_2.npz.tmp", "w") as f:
        f.write("garbage")
    assert tckpt.latest_step(str(tmp_path)) == 1
    _, restored = mgr.restore_latest(tree)
    np.testing.assert_allclose(restored["w"].numpy(), 1.0)


def test_checkpoint_shape_and_count_mismatch_rejected(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError):
        mgr.restore_latest({"w": torch.ones(5)})
    with pytest.raises(ValueError):
        mgr.restore_latest({"w": torch.ones(4), "v": torch.ones(4)})
    assert tckpt.latest_step(str(tmp_path / "none")) is None
