"""The port's CUDA kernels against their plain versions, on a card.

Imports no JAX, so it runs where the kernels do:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA card every test here skips (the kernels have no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, moe_gmm

pytestmark = pytest.mark.gpu

# f32: summation order only; bf16: one rounding of the output (8 bits).
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 plain versions
    return torch.device("cuda")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _gmm_inputs(device, e, c, k, n, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(e, c, k, generator=gen, device=device).to(dtype)
    w = torch.randn(e, k, n, generator=gen, device=device).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", [
    (8, 2, 4096, 1376),    # decode step (bf16: wgmma at width 8)
    (8, 2, 1376, 4096),
    (8, 40, 1376, 4096),   # calibration and prefill at batch 4 x 32
    (3, 130, 100, 36),     # ragged (N % 8 != 0: fma)
    (3, 3, 100, 36),
    (5, 1, 7, 8),          # K % 8 != 0: fma
    # every C tile of the wgmma path at the serve K/N, up to a real
    # prefill's C = 2560 (ten tiles of 256)
    *[(8, c, 4096, 1376) for c in (1, 8, 9, 40, 64, 65, 256, 257, 2560)],
    (8, 40, 1000, 1376),   # K not a multiple of the 64-deep K step
    (1, 2, 4096, 1376),    # few blocks
])
def test_gmm_kernel_matches_plain(cuda_device, e, c, k, n, dtype):
    x, w = _gmm_inputs(cuda_device, e, c, k, n, dtype)
    before = moe_gmm.launches
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    want = moe_gmm.gmm_plain(x, w)
    # Sums over K ~ sqrt(K) in size: compare relative to the largest entry.
    scale = float(want.float().abs().max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **TOL[dtype])


@pytest.mark.parametrize("e,c,k,n", [(8, 2, 4096, 1376), (8, 40, 1376, 4096),
                                     (8, 257, 4096, 1376), (1, 2, 4096, 1376)])
def test_gmm_kernel_is_bitwise_repeatable(cuda_device, e, c, k, n):
    """No float atomics: each block sums all of K itself, in order."""
    x, w = _gmm_inputs(cuda_device, e, c, k, n, torch.bfloat16, seed=3)
    first = moe_gmm.gmm(x, w)
    assert torch.equal(moe_gmm.gmm(x, w), first)


@pytest.mark.parametrize("e,c,k,n,dtype,path", [
    (8, 2, 4096, 1376, torch.bfloat16, "wgmma"),
    (8, 40, 1376, 4096, torch.bfloat16, "wgmma"),
    (8, 2560, 4096, 1376, torch.bfloat16, "wgmma"),
    (8, 2, 4096, 1376, torch.float32, "fma"),
    (3, 130, 100, 36, torch.bfloat16, "fma"),
])
def test_gmm_kernel_counts_its_path(cuda_device, e, c, k, n, dtype, path):
    x, w = _gmm_inputs(cuda_device, e, c, k, n, dtype)
    before = dict(moe_gmm.path_launches)
    moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    moved = {p: moe_gmm.path_launches[p] - before[p] for p in before}
    assert moved == {p: int(p == path) for p in before}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,s,hd", [(4, 32, 1, 49, 128),
                                          (2, 2, 3, 333, 64),
                                          (1, 2, 6, 2048, 256)])
def test_decode_attention_kernel_matches_plain(cuda_device, b, hkv, g, s, hd,
                                               dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, hkv, g, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    pos = torch.randint(0, s, (b,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    before = decode_attn.launches
    got = decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    want = decode_attn.decode_attention_plain(q, k, v, pos)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_decode_attention_kernel_reads_strided_cache(cuda_device):
    """The model's (B, S, Hkv, hd) cache, passed as a transposed view."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    b, s, hkv, hd = 4, 49, 32, 128
    cache_k = torch.randn(b, s, hkv, hd, generator=gen, device=cuda_device)
    cache_v = torch.randn(b, s, hkv, hd, generator=gen, device=cuda_device)
    q = torch.randn(b, hkv, 1, hd, generator=gen, device=cuda_device)
    pos = torch.tensor([32, 40, 47, 48], dtype=torch.int32, device=cuda_device)
    got = decode_attn.decode_attention(q, cache_k.transpose(1, 2),
                                       cache_v.transpose(1, 2), pos)
    want = decode_attn.decode_attention_plain(
        q, cache_k.transpose(1, 2).contiguous(),
        cache_v.transpose(1, 2).contiguous(), pos)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[torch.float32])


def test_wrappers_refuse_mixed_devices(cuda_device):
    with pytest.raises(ValueError):
        moe_gmm.gmm(torch.ones(2, 3, 4, device=cuda_device),
                    torch.ones(2, 4, 5))
    with pytest.raises(TypeError):
        moe_gmm.gmm(torch.ones(2, 3, 4, device=cuda_device, dtype=torch.float16),
                    torch.ones(2, 4, 5, device=cuda_device, dtype=torch.float16))


# --------------------------------------------------------------------- #
# The fleet simulator's kernels: deposit and backlog_scan
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n_rows,n_cols,n,case", [
    (17, 300, 1000, "shuffled"),
    (144, 5000, 40000, "shuffled"),       # several tiles per row
    (40, 2600, 30000, "grouped"),         # row-grouped with a padded tail
    (8, 128, 0, "shuffled"),              # empty table
    (3, 64, 5000, "duplicates"),          # many triples on few cells
    (70000, 3, 100000, "shuffled"),       # more rows than grid.y takes
])
def test_deposit_kernel_is_bitwise_the_plain_version(cuda_device, n_rows,
                                                     n_cols, n, case):
    from repro_torch.kernels import deposit
    rng = np.random.default_rng(n + n_cols)
    rows = rng.integers(0, n_rows, n)
    cols = rng.integers(0, n_cols if case != "duplicates" else 4, n)
    vals = rng.random(n) * 0.05
    # The plain version takes the table as it came; the kernel takes it
    # stably grouped by row (as the fleet's chunk table comes).
    want = deposit.deposit_plain(*(torch.from_numpy(a).to(cuda_device)
                                   for a in (rows, cols, vals)),
                                 n_rows, n_cols)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ptr = torch.from_numpy(np.searchsorted(
        rows, np.arange(n_rows + 1))).to(cuda_device)
    if case == "grouped":                 # zero-valued tail, not read
        pad = 8192 - n % 8192
        rows = np.concatenate([rows, np.zeros(pad, np.int64)])
        cols = np.concatenate([cols, np.zeros(pad, np.int64)])
        vals = np.concatenate([vals, np.zeros(pad)])
    r, c, v = (torch.from_numpy(a).to(cuda_device) for a in (rows, cols, vals))
    before = deposit.launches
    got = deposit.deposit(r, c, v, n_rows, n_cols, row_ptr=row_ptr)
    torch.cuda.synchronize()
    assert deposit.launches == before + 1
    assert got.shape == (n_rows, n_cols) and torch.equal(got, want)


def test_deposit_kernel_needs_row_ptr(cuda_device):
    from repro_torch.kernels import deposit
    before = deposit.launches
    with pytest.raises(ValueError, match="row_ptr"):
        deposit.deposit(torch.zeros(3, dtype=torch.int64, device=cuda_device),
                        torch.arange(3, device=cuda_device),
                        torch.ones(3, dtype=torch.float64, device=cuda_device),
                        2, 4)
    assert deposit.launches == before


@pytest.mark.parametrize("t,c,cap", [(1, 5, 10.0), (3000, 700, 10.0),
                                     (257, 33, 0.3)])
def test_backlog_scan_kernel_is_bitwise_the_plain_loop(cuda_device, t, c,
                                                       cap):
    from repro_torch.kernels import backlog_scan
    rng = np.random.default_rng(t)
    work = torch.from_numpy(
        (rng.random((t, c)) * (rng.random((t, c)) < 0.3) * 0.2)
        .astype(np.float32)).to(cuda_device)
    before = backlog_scan.launches
    got = backlog_scan.backlog_scan(work, cap, 0.05)
    torch.cuda.synchronize()
    assert backlog_scan.launches == before + 1
    assert torch.equal(got, backlog_scan.backlog_scan_plain(work, cap, 0.05))
