"""Port kernels vs the reference's Pallas kernels and oracles.

On the CPU the port's ``gmm`` / ``decode_attention`` run their plain
versions; the reference runs its Pallas kernels in interpret mode and its
jnp oracles.  Both get the same numpy inputs.  The CUDA kernels
themselves run only on a card: ``test_torch_kernels_gpu.py`` holds them
to their plain versions there, and ``chip_smoke.py`` does so at the
serve path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import decode_attention as jax_decode_attention
from repro.kernels.ops import expert_ffn_pallas
from repro.kernels.ops import gmm as jax_gmm
from repro.kernels.ref import decode_attention_ref, gmm_ref
from repro.models.moe import expert_ffn as jax_expert_ffn
from repro_torch.kernels import (admission_ctrl, admission_window,
                                 backlog_scan, build,
                                 decode_attn, deposit, moe_gmm, ops)

# f32: summation order only; bf16: one rounding of the output (8 bits).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a CPU torch tensor of ``dtype``."""
    return (jnp.asarray(a, JNP[dtype]),
            torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype]))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


# --------------------------------------------------------------------- #
# gmm
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,k,n", [
    (8, 96, 64, 48),      # ragged on every axis against the kernel's tiles
    (3, 130, 100, 36),    # awkward primes
    (8, 2, 64, 40),       # decode-sized buckets (C = 2)
])
def test_gmm_matches_reference(e, c, k, n, dtype):
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(e, c, k)).astype(np.float32)
    w_np = rng.normal(size=(e, k, n)).astype(np.float32)
    xj, xt = _pair(x_np, dtype)
    wj, wt = _pair(w_np, dtype)
    out = moe_gmm.gmm(xt, wt)
    assert out.shape == (e, c, n) and out.dtype == TORCH[dtype]
    pallas = jax_gmm(xj, wj, block_c=64, block_n=128, block_k=64,
                     interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(gmm_ref(xj, wj)), **TOL[dtype])


def test_expert_ffn_matches_reference():
    e, c, d, f = 4, 32, 64, 48
    rng = np.random.default_rng(3)
    p_np = {"w_gate": rng.normal(size=(e, d, f)) * 0.1,
            "w_up": rng.normal(size=(e, d, f)) * 0.1,
            "w_down": rng.normal(size=(e, f, d)) * 0.1}
    xs_np = rng.normal(size=(e, c, d))
    p_j = {k: jnp.asarray(v, jnp.float32) for k, v in p_np.items()}
    p_t = {k: torch.tensor(v, dtype=torch.float32) for k, v in p_np.items()}
    got = ops.expert_ffn(p_t, torch.tensor(xs_np, dtype=torch.float32),
                         torch.float32)
    xs_j = jnp.asarray(xs_np, jnp.float32)
    for want in (expert_ffn_pallas(p_j, xs_j, jnp.float32, interpret=True),
                 jax_expert_ffn(p_j, xs_j, jnp.float32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------- #
# decode_attention
# --------------------------------------------------------------------- #


def _attn_inputs(b, hkv, g, s, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    pos = rng.integers(0, s, size=(b,)).astype(np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("b,hkv,g,s,hd,bs", [
    (1, 1, 1, 333, 64, 128),    # MQA, ragged S
    (2, 2, 3, 96, 64, 64),      # G = 3
    (4, 4, 1, 49, 32, 32),      # the serve path's S = 32 + 16 + 1
])
def test_decode_attention_matches_reference(b, hkv, g, s, hd, bs):
    q, k, v, pos = _attn_inputs(b, hkv, g, s, hd)
    got = decode_attn.decode_attention(*(torch.from_numpy(a)
                                         for a in (q, k, v, pos)))
    assert got.shape == q.shape and got.dtype == torch.float32
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    pallas = jax_decode_attention(*args, block_s=bs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(decode_attention_ref(*args)),
                               **TOL["float32"])


def test_decode_attention_respects_mask_strictly():
    """Garbage beyond pos must not leak into the output (the reference's
    poison test, redone on the port)."""
    q, k, v, _ = _attn_inputs(1, 1, 2, 128, 64, seed=5)
    pos = torch.tensor([17], dtype=torch.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out1 = decode_attn.decode_attention(qt, kt, vt, pos)
    k2, v2 = kt.clone(), vt.clone()
    k2[:, :, 18:] = 1e9
    v2[:, :, 18:] = -1e9
    out2 = decode_attn.decode_attention(qt, k2, v2, pos)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_decode_attention_reads_strided_cache():
    """A transposed view of the model's (B, S, Hkv, hd) cache gives the
    same result as a contiguous (B, Hkv, S, hd) copy."""
    q, k, v, pos = _attn_inputs(2, 4, 2, 40, 32, seed=2)
    kc = torch.from_numpy(k).transpose(1, 2).contiguous()   # (B,S,Hkv,hd)
    vc = torch.from_numpy(v).transpose(1, 2).contiguous()
    args = (torch.from_numpy(q), kc.transpose(1, 2), vc.transpose(1, 2),
            torch.from_numpy(pos))
    want = decode_attn.decode_attention_plain(*(torch.from_numpy(a)
                                                for a in (q, k, v, pos)))
    np.testing.assert_array_equal(decode_attn.decode_attention(*args).numpy(),
                                  want.numpy())


# --------------------------------------------------------------------- #
# Wrapper contract: CPU -> plain version, anything else -> kernel or raise
# --------------------------------------------------------------------- #


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launch_counts()
    moe_gmm.gmm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    decode_attn.decode_attention(torch.ones(1, 1, 1, 8), torch.ones(1, 1, 4, 8),
                                 torch.ones(1, 1, 4, 8),
                                 torch.zeros(1, dtype=torch.int32))
    deposit.deposit(torch.zeros(3, dtype=torch.int64), torch.arange(3),
                    torch.ones(3, dtype=torch.float64), 2, 4)
    backlog_scan.backlog_scan(torch.ones(5, 3), 10.0, 0.05)
    admission_ctrl.admission_ctrl(
        torch.ones(4, 1, 2), torch.zeros(2, 3), torch.zeros(2),
        torch.ones(1, 2, 3), torch.ones(1), torch.ones(1), increase=0.1,
        decrease=0.6, admit_min=0.05)
    admission_window.admission_window(*_window_args("cpu"))
    assert ops.launch_counts() == {"gmm": 0, "decode_attention": 0,
                                   "deposit": 0, "backlog_scan": 0,
                                   "admission_window": 0,
                                   "admission_ctrl": 0}


def _window_args(device):
    """admission_window's arguments at a toy size: T = 6, F = 1, C = 4,
    one slot, P = 2, L = 2, I = 2, two windows."""
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    return (torch.ones(6, 1, 4, device=dev), torch.ones(1, 4, device=dev),
            10.0, 0.05, torch.zeros(1, 2, 2, **i64),
            torch.zeros(1, 2, 4, **i64), torch.zeros(6, **i64),
            torch.tensor([0, 0, 0, 1, 1, 2], **i64), 2)


@pytest.mark.parametrize("op", ["gmm", "decode_attention", "deposit",
                                "backlog_scan", "admission_window",
                                "admission_ctrl"])
def test_non_cpu_tensor_never_falls_back(op, monkeypatch):
    """A tensor off the CPU never runs the plain version.  ``gmm`` and
    ``decode_attention`` take ``meta`` tensors (the dry run) and return an
    empty ``meta`` result of the right shape, computing and launching
    nothing; the other kernels' checks refuse a non-CUDA device."""
    meta = torch.device("meta")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")
    if op == "gmm":
        monkeypatch.setattr(moe_gmm, "gmm_plain", plain)
        out = moe_gmm.gmm(torch.empty(2, 3, 4, device=meta),
                          torch.empty(2, 4, 5, device=meta))
        assert out.device == meta and out.shape == (2, 3, 5)
    elif op == "decode_attention":
        monkeypatch.setattr(decode_attn, "decode_attention_plain", plain)
        out = decode_attn.decode_attention(
            torch.empty(1, 1, 1, 8, device=meta),
            torch.empty(1, 1, 4, 8, device=meta),
            torch.empty(1, 1, 4, 8, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta))
        assert out.device == meta and out.shape == (1, 1, 1, 8)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            if op == "deposit":
                deposit.deposit(
                    torch.empty(3, dtype=torch.int64, device=meta),
                    torch.empty(3, dtype=torch.int64, device=meta),
                    torch.empty(3, dtype=torch.float64, device=meta), 2, 4)
            elif op == "backlog_scan":
                backlog_scan.backlog_scan(torch.empty(5, 3, device=meta),
                                          10.0, 0.05)
            elif op == "admission_window":
                admission_window.admission_window(*_window_args("meta"))
            else:
                admission_ctrl.admission_ctrl(
                    torch.empty(4, 1, 2, device=meta),
                    torch.empty(2, 3, device=meta),
                    torch.empty(2, device=meta),
                    torch.empty(1, 2, 3, device=meta),
                    torch.empty(1, device=meta),
                    torch.empty(1, device=meta), increase=0.1, decrease=0.6,
                    admit_min=0.05)
    assert ops.launch_counts()[op] == 0


def test_timed_call_times_the_call():
    calls = []
    t = ops.timed_call(lambda: calls.append(moe_gmm.gmm(torch.ones(2, 3, 4),
                                                        torch.ones(2, 4, 5))),
                       iters=3, warmup=1)
    assert 0 < t < 10 and len(calls) == 4


def test_kernel_library_name_follows_its_source():
    for name in build.KERNELS:
        path = build.lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert build.lib_path("moe_gmm") != build.lib_path("decode_attn")
