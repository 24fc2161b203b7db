"""The port's CUDA kernels against their plain versions, on a card.

Imports no JAX, so it runs where the kernels do:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA card every test here skips (the kernels have no CPU mode).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, decode_attn, moe_gmm

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
    # deepseek-moe-16b: decode (C floors at top_k = 6), prefill at
    # T = 128 (C = 15), and calibration's f32 buckets (C = 32)
    (64, 6, 2048, 1408), (64, 6, 1408, 2048),
    (64, 15, 2048, 1408), (64, 15, 1408, 2048),
    (64, 32, 2048, 1408), (64, 32, 1408, 2048),
    (8, 32, 4096, 1376),   # llama-moe-3.5b's calibration buckets
    # granite-moe-3b-a800m: 40 experts, decode (C floors at top_k = 8)
    # and prefill at T = 128 (C = 32); slotted to 48 buckets (prefill
    # C = 27); slotted llama-moe-3.5b: 16 half-experts of 688, whose K and
    # N leave tails of the 64-deep K step and the 128-wide N block
    (40, 8, 1536, 512), (40, 8, 512, 1536),
    (40, 32, 1536, 512), (40, 32, 512, 1536),
    (48, 8, 1536, 512), (48, 27, 512, 1536),
    (16, 2, 4096, 688), (16, 2, 688, 4096),
    (16, 40, 4096, 688), (16, 40, 688, 4096),
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
    (40, 8, 1536, 512, torch.bfloat16, "wgmma"),
    (16, 2, 4096, 688, torch.bfloat16, "wgmma"),
    (16, 40, 688, 4096, torch.bfloat16, "wgmma"),
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
                                          (1, 2, 6, 2048, 256),
                                          # deepseek-moe-16b's decode and
                                          # its calibration sweep
                                          (4, 16, 1, 49, 128),
                                          *[(b, 16, 1, 512, 128)
                                            for b in (1, 2, 4, 8)],
                                          # head dim 64 with 3 of a block's
                                          # 4 heads (granite, smollm), 8
                                          # heads in two blocks (qwen2.5),
                                          # llava's 4, minicpm's and
                                          # musicgen's MHA at hd 64
                                          (4, 8, 3, 49, 64),
                                          (4, 3, 3, 2048, 64),
                                          (4, 2, 8, 49, 128),
                                          (4, 2, 8, 2048, 128),
                                          (4, 8, 4, 49, 128),
                                          (4, 36, 1, 49, 64),
                                          (4, 24, 1, 2048, 64)])
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


def _deposit_table(case, n_rows, n_cols, n, rng):
    """(rows, cols, vals) in table order, not yet grouped by row."""
    rows = rng.integers(0, n_rows, n)
    cols = rng.integers(0, n_cols if case != "duplicates" else 4, n)
    vals = rng.random(n) * 0.05
    if case == "hot":                     # thousands of triples on one cell
        cols[rng.random(n) < 0.8] = min(n_cols - 1, 700)
    elif case == "skewed":                # one row holds most of the table
        rows[rng.random(n) < 0.9] = n_rows // 2
    elif case == "pile":                  # past the horizon: bin T - 1
        cols[rng.random(n) < 0.5] = n_cols - 1
    elif case == "fleet":                 # events of 1-4 neighbouring bins,
        start = rng.integers(0, n_cols, n // 4 + 1)     # a pile on T - 1 and
        cols = np.minimum(np.repeat(start, 4)[:n] + np.tile(np.arange(4),
                                                             n // 4 + 1)[:n],
                          n_cols - 1)                   # zero-valued triples
        zero = rng.random(n) < 0.1                      # on bin 0
        cols[zero], vals[zero] = 0, 0.0
        cols[rng.random(n) < 0.05] = n_cols - 1
    return rows, cols, vals


@pytest.mark.parametrize("n_rows,n_cols,n,case", [
    (17, 300, 1000, "shuffled"),
    (144, 5000, 40000, "shuffled"),       # several tiles per row
    (40, 2600, 30000, "grouped"),         # row-grouped with a padded tail
    (8, 128, 0, "shuffled"),              # empty table
    (3, 64, 5000, "duplicates"),          # many triples on few cells
    (70000, 3, 100000, "shuffled"),       # more rows than grid.y takes
    (4, 3000, 40000, "hot"),              # a cell with ~8000 triples
    (9, 40_966, 200000, "skewed"),        # one row with 90 % of the table
    (5, 100, 20000, "pile"),              # T below one tile, a pile on T - 1
    (3, 40_966, 300000, "fleet"),         # the fleet's T at a few rows
    (2, 1_900_000, 20000, "shuffled"),    # past 3584 tiles: 8 bucket warps
])
def test_deposit_kernel_is_bitwise_the_plain_version(cuda_device, n_rows,
                                                     n_cols, n, case):
    from repro_torch.kernels import deposit
    rng = np.random.default_rng(n + n_cols)
    rows, cols, vals = _deposit_table(case, n_rows, n_cols, n, rng)
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


# --------------------------------------------------------------------- #
# decode_attention split over S (decode_splits) with its in-launch merge
# --------------------------------------------------------------------- #


def _long_cache(device, g, dtype, layout, b=5, hkv=8, s=2048, hd=128, seed=4):
    """q and a k/v cache of S = 2048 in the kernel's (B, Hkv, S, hd) layout
    or as a transposed view of the model's (B, S, Hkv, hd) cache, with pos
    at 0, S - 1 and around the first split boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, hkv, g, hd, generator=gen, device=device).to(dtype)
    if layout == "bhsd":
        k, v = (torch.randn(b, hkv, s, hd, generator=gen, device=device)
                .to(dtype) for _ in range(2))
    else:
        k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=device)
                .to(dtype).transpose(1, 2) for _ in range(2))
    _, chunk = decode_attn.decode_splits(b, hkv, s,
                                         build.sm_count(q.device.index))
    pos = torch.tensor([0, s - 1, chunk - 1, chunk, chunk + 1],
                       dtype=torch.int32, device=device)
    return q, k, v, pos


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 3, 6])
def test_decode_attention_split_matches_plain(cuda_device, g, dtype, layout):
    q, k, v, pos = _long_cache(cuda_device, g, dtype, layout)
    assert decode_attn.decode_splits(
        5, 8, 2048, build.sm_count(cuda_device.index))[0] > 1
    before = decode_attn.launches
    got = decode_attn.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    want = decode_attn.decode_attention_plain(q, k.contiguous(),
                                              v.contiguous(), pos)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_decode_attention_split_is_bitwise_repeatable(cuda_device, layout):
    """The splits are merged in split order, whichever block ends last."""
    q, k, v, pos = _long_cache(cuda_device, 1, torch.bfloat16, layout, seed=5)
    first = decode_attn.decode_attention(q, k, v, pos)
    for _ in range(3):
        assert torch.equal(decode_attn.decode_attention(q, k, v, pos), first)


def test_decode_attention_ignores_rows_past_pos_on_the_card(cuda_device):
    q, k, v, pos = _long_cache(cuda_device, 3, torch.float32, "bhsd", seed=6)
    got = decode_attn.decode_attention(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    for i, p in enumerate(pos.tolist()):
        k2[i, :, p + 1:] = float("nan")
        v2[i, :, p + 1:] = float("nan")
    assert torch.equal(decode_attn.decode_attention(q, k2, v2, pos), got)


# --------------------------------------------------------------------- #
# decode_attention's partial mode (context parallelism): f32 out and lse
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,s,hd,layout", [
    (5, 8, 3, 2048, 128, "bshd"),     # split over S, a view of the cache
    (1, 1, 4, 96, 64, "bhsd"),        # one split
])
def test_decode_attention_partial_matches_plain(cuda_device, b, hkv, g, s,
                                                hd, layout, dtype):
    """The partial mode against its plain version: the f32 normalized
    output and log-sum-exp of the rows up to pos, an empty window
    (pos = -1) giving out = 0 and lse = -inf; one launch, counted as a
    partial one; the normal mode unchanged beside it."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + g)
    q = torch.randn(b, hkv, g, hd, generator=gen, device=cuda_device).to(dtype)
    if layout == "bhsd":
        k, v = (torch.randn(b, hkv, s, hd, generator=gen, device=cuda_device)
                .to(dtype) for _ in range(2))
    else:
        k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=cuda_device)
                .to(dtype).transpose(1, 2) for _ in range(2))
    pos = torch.tensor([-1, s - 1, s // 2, 0, 70][:b], dtype=torch.int32,
                       device=cuda_device)
    before = decode_attn.mode_launches["partial"]
    out, lse = decode_attn.decode_attention_partial(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attn.mode_launches["partial"] == before + 1
    assert out.dtype == lse.dtype == torch.float32
    want, want_lse = decode_attn.decode_attention_partial_plain(
        q, k.contiguous(), v.contiguous(), pos)
    tol = TOL[torch.float32] if dtype == torch.float32 else \
        dict(atol=1e-4, rtol=1e-4)       # f32 math on the same bf16 inputs
    np.testing.assert_allclose(_np(out), _np(want), **tol)
    np.testing.assert_allclose(_np(lse), _np(want_lse), **tol)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool(torch.isneginf(lse[0]).all())
    full = decode_attn.decode_attention(q, k, v, pos.clamp(min=0))
    keep = pos >= 0
    np.testing.assert_allclose(_np(out[keep].to(dtype)), _np(full[keep]),
                               **TOL[dtype])


# --------------------------------------------------------------------- #
# backlog_scan chunked over T (scan_chunk), bitwise the plain loop
# --------------------------------------------------------------------- #


def _scan_work(kind, t, c, dt, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        w = rng.random((t, c)) * (rng.random((t, c)) < 0.05) * 2.0
    elif kind == "heavy":
        w = rng.random((t, c)) * 0.5
    elif kind == "zero":
        w = np.zeros((t, c))
    else:                       # never: b sits strictly inside (0, U)
        w = np.full((t, c), dt)
        w[0] = 5.0
    return torch.from_numpy(w.astype(np.float32))


@pytest.mark.parametrize("kind,t,c,cap", [
    ("sparse", 5000, 9504, 10.0),    # run_many's width (11 x 864 columns)
    ("never", 5000, 64, 10.0),       # every chunk after the first re-runs
    ("heavy", 3000, 100, 0.03),      # cap < dt
    ("heavy", 3000, 100, 0.05),      # cap == dt
    ("zero", 3000, 100, 10.0),       # all-zero work
    ("sparse", 1, 40, 10.0),         # T = 1
    ("sparse", 2500, 33, 10.0),      # T not a multiple of the chunk, C of 32
    ("heavy", 4500, 70, 10.0),       # overflows: coalesces at the cap
])
def test_backlog_scan_chunks_are_bitwise_the_plain_loop(cuda_device, kind, t,
                                                        c, cap):
    from repro_torch.kernels import backlog_scan
    dt = 0.05
    work = _scan_work(kind, t, c, dt).to(cuda_device)
    chunk = backlog_scan.scan_chunk(
        t, c, build.sm_count(cuda_device.index))
    coal = torch.full((-(-t // chunk), c), -2, dtype=torch.int32,
                      device=cuda_device)
    before = backlog_scan.launches
    got = backlog_scan.backlog_scan(work, cap, dt, coalescence=coal)
    torch.cuda.synchronize()
    assert backlog_scan.launches == before + 1
    assert torch.equal(got, backlog_scan.backlog_scan_plain(work, cap, dt))
    assert bool((coal[0] == 0).all())                  # chunk 0 is exact
    assert bool(((coal >= -1) & (coal <= chunk)).all())
    if kind == "never":
        assert bool((coal[1:] == -1).all())
    if cap <= dt:
        assert bool((coal == 0).all())
    # A second launch reuses the ticket and status words (a new epoch).
    assert torch.equal(backlog_scan.backlog_scan(work, cap, dt), got)


@pytest.mark.parametrize("t,c", [(5000, 864), (2500, 33)])
def test_backlog_scan_reads_a_transposed_view(cuda_device, t, c):
    """The fleet's (F, rows, T) plane as a (T, F * rows) view, read in
    place through its strides."""
    from repro_torch.kernels import backlog_scan
    plane = _scan_work("sparse", t, c, 0.05, seed=7).T.contiguous()
    view = plane.to(cuda_device).T                      # strides (1, T)
    assert not view.is_contiguous()
    got = backlog_scan.backlog_scan(view, 10.0, 0.05)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert torch.equal(got, backlog_scan.backlog_scan_plain(view.contiguous(),
                                                            10.0, 0.05))


@pytest.mark.parametrize("hd,dtype,offset", [(36, torch.bfloat16, 0),
                                             (64, torch.float32, 1)])
def test_decode_attention_refuses_unaligned_rows(cuda_device, hd, dtype,
                                                 offset):
    """Rows are copied 16 bytes at a time: a head_dim or a view whose rows
    do not start on 16 bytes is refused, not launched."""
    q = torch.zeros(1, 2, 1, hd, dtype=dtype, device=cuda_device)
    kv = torch.zeros(1, 2, 64 * hd + offset, dtype=dtype, device=cuda_device)
    k = kv[..., offset:].reshape(1, 2, 64, hd)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = decode_attn.launches
    with pytest.raises(ValueError, match="16 bytes"):
        decode_attn.decode_attention(q, k, k, pos)
    assert decode_attn.launches == before


# --------------------------------------------------------------------- #
# admission_ctrl: the AIMD / PID cell over control bins
# --------------------------------------------------------------------- #


def _ctrl_inputs(device, n_ctrl, f, p, g, tt, tp, seed=0):
    """Window maxima that cross the targets both ways, anchors, targets."""
    rng = np.random.default_rng(seed)
    win = rng.gamma(0.6, 3.0, (n_ctrl, f, p)) \
        * (rng.random((n_ctrl, f, p)) < 0.7)

    def t32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    return (t32(win), t32(rng.random((p, g)) * 2.0), t32(rng.random(p) * 0.5),
            t32(np.ones((f, p, g))), t32(np.full(f, tt) * rng.uniform(
                0.5, 1.5, f)), t32(np.full(f, tp)))


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("n_ctrl,f,p,g,tt,tp", [
    (4096, 1, 3, 8, 5.0, float("inf")),     # run() on the paper's world
    (4096, 4, 3, 8, 5.0, float("inf")),     # a run_many target sweep
    (333, 5, 7, 3, 4.0, 1.5),               # F * P * G = 105: not a warp's
    (1, 2, 3, 2, 4.0, 1.5),                 # one control bin
    (70, 3, 130, 1, 4.0, 1.5),              # several blocks, ragged tail
    (100, 2, 3, 4, float("inf"), 1.5),      # infinite TTFT target
    (100, 2, 3, 4, float("inf"), float("inf")),   # both infinite
])
def test_admission_ctrl_kernel_is_bitwise_the_plain_loop(cuda_device, policy,
                                                         n_ctrl, f, p, g,
                                                         tt, tp):
    from repro_torch.kernels import admission_ctrl
    args = _ctrl_inputs(cuda_device, n_ctrl, f, p, g, tt, tp)
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=torch.linspace(
            0.5, 2.0, p, device=cuda_device))
    before = admission_ctrl.launches
    got = admission_ctrl.admission_ctrl(*args, **kw)
    torch.cuda.synchronize()
    assert admission_ctrl.launches == before + 1
    want = admission_ctrl.admission_ctrl_plain(*args, **kw)
    assert got.shape == (n_ctrl, f, p, g)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    # the plain loop is the same on the CPU
    cpu_kw = dict(kw, pid=None if kw["pid"] is None
                  else dict(kw["pid"], gain=kw["pid"]["gain"].cpu()))
    np.testing.assert_array_equal(
        admission_ctrl.admission_ctrl_plain(*(a.cpu() for a in args),
                                            **cpu_kw).numpy(),
        want.cpu().numpy())


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_admission_ctrl_reads_windows_in_any_layout(cuda_device, policy):
    """Windows k-contiguous (as admission_window returns them) or a
    sliced view: the same result, read in place."""
    from repro_torch.kernels import admission_ctrl
    args = list(_ctrl_inputs(cuda_device, 3000, 2, 3, 4, 5.0, 1.5, seed=5))
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=torch.linspace(
            0.5, 2.0, 3, device=cuda_device))
    want = admission_ctrl.admission_ctrl_plain(*args, **kw)
    for win in (args[0].permute(1, 2, 0).contiguous().permute(2, 0, 1),
                torch.cat([args[0], args[0]], dim=2)[:, :, 3:]):
        got = admission_ctrl.admission_ctrl(win, *args[1:], **kw)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_admission_ctrl_without_control_bins_launches_nothing(cuda_device):
    from repro_torch.kernels import admission_ctrl
    args = _ctrl_inputs(cuda_device, 0, 2, 3, 4, 4.0, 1.5)
    before = admission_ctrl.launches
    out = admission_ctrl.admission_ctrl(*args, increase=0.1, decrease=0.6,
                                        admit_min=0.05)
    assert out.shape == (0, 2, 3, 4) and admission_ctrl.launches == before


def _never_coalescing(device, n_ctrl, f, p, g, policy):
    """Windows and a cell on which no chunk's bracket runs ever meet (see
    ``never_coalescing_ctrl`` of tests/test_torch_kernel_designs.py)."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "aimd":        # admit0 = +inf, every window over
        win, admit0 = full((n_ctrl, f, p), 5.0), full((f, p, g), float("inf"))
    else:                       # every window on the target: err = 0
        win, admit0 = full((n_ctrl, f, p), 3.0), full((f, p, g), 0.5)
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=full((p,), 1.0))
    return (win, full((p, g), 1.0), full((p,), 0.0), admit0, full((f,), 4.0),
            full((f,), float("inf"))), kw


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("n_ctrl", [6005, 100, 33])
def test_admission_ctrl_never_coalescing_is_exact(cuda_device, policy,
                                                  n_ctrl):
    from repro_torch.kernels import admission_ctrl
    args, kw = _never_coalescing(cuda_device, n_ctrl, 2, 3, 4, policy)
    coal = torch.empty((24, admission_ctrl.LANES), dtype=torch.int32,
                       device=cuda_device)
    got = admission_ctrl.admission_ctrl(*args, coalescence=coal, **kw)
    torch.cuda.synchronize()
    want = admission_ctrl.admission_ctrl_plain(*args, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    chunk = admission_ctrl.ctrl_chunk(n_ctrl)
    live = -(-n_ctrl // chunk)
    assert bool((coal[:, 0] == 0).all())
    assert bool((coal[:, 1:live] == -1).all())


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("case", ["nan windows", "both targets inf",
                                  "admit0 outside", "over then under"])
def test_admission_ctrl_kernel_edge_cases_are_bitwise(cuda_device, policy,
                                                      case):
    """NaN windows and delta's inf - inf (NaN for good from there),
    admit0 below admit_min, above 1 and infinite, and windows that cross
    the target once (every later chunk's runs meet on a number)."""
    from repro_torch.kernels import admission_ctrl
    tt, tp = (float("inf"), float("inf")) if case == "both targets inf" \
        else (5.0, 1.5)
    args = list(_ctrl_inputs(cuda_device, 3000, 2, 3, 4, tt, tp, seed=3))
    if case == "nan windows":
        args[0][1000, 0] = float("nan")
    elif case == "admit0 outside":
        args[3] = torch.tensor([0.0, 0.01, 1.7, 40.0, -2.0, float("inf"),
                                -float("inf"), float("nan")] * 3,
                               device=cuda_device).reshape(2, 3, 4)
    elif case == "over then under":
        args[0][:1500] = 100.0
        args[0][1500:] = 0.01
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=torch.linspace(
            0.5, 2.0, 3, device=cuda_device))
    got = admission_ctrl.admission_ctrl(*args, **kw)
    torch.cuda.synchronize()
    want = admission_ctrl.admission_ctrl_plain(*args, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_admission_ctrl_refuses_ranges_outside_its_bracket(cuda_device):
    from repro_torch.kernels import admission_ctrl
    args = _ctrl_inputs(cuda_device, 10, 1, 2, 2, 4.0, 1.5)
    before = admission_ctrl.launches
    for bad in (dict(decrease=1.0), dict(increase=0.0), dict(admit_min=1.5)):
        kw = dict(dict(increase=0.1, decrease=0.6, admit_min=0.05), **bad)
        with pytest.raises(ValueError, match="AdmissionConfig"):
            admission_ctrl.admission_ctrl(*args, **kw)
    assert admission_ctrl.launches == before


def _window_case(device, t, f, c, p, n_layers, n_exp, n_slots, every,
                 last_ctrl, seed=0):
    rng = np.random.default_rng(seed)
    wait = rng.gamma(0.5, 0.3, (t, f, c)) * (rng.random((t, f, c)) < 0.6)
    # the fleet passes the last bin's work as a strided view of its plane
    work = torch.from_numpy(rng.random((f, c, 3)).astype(np.float32))
    cuts = np.sort(rng.choice(np.arange(1, t), n_slots - 1, replace=False))
    ctrl = (np.arange(t) + 1) % every == 0
    ctrl[-1] = last_ctrl
    from repro_torch.kernels.admission_window import control_segments
    seg, n_ctrl = control_segments(torch.from_numpy(ctrl))
    return (torch.from_numpy(wait.astype(np.float32)).to(device),
            work.to(device)[:, :, -1], 0.9, 0.05,
            torch.from_numpy(rng.integers(0, c, (n_slots, p, n_layers))
                             ).to(device),
            torch.from_numpy(rng.integers(0, c, (n_slots, p,
                                                 n_layers * n_exp))
                             ).to(device),
            torch.from_numpy(np.searchsorted(cuts, np.arange(t),
                                             side="right")).to(device),
            seg.to(device), n_ctrl)


@pytest.mark.parametrize("t,f,c,p,n_layers,n_exp,n_slots,every,last_ctrl", [
    (6_005, 1, 864, 3, 32, 8, 3, 10, False),   # the paper's widths, F = 1
    (6_005, 4, 864, 3, 32, 8, 3, 10, True),    # F = 4, control bin at T - 1
    (157, 1, 13, 3, 4, 3, 4, 10, True),
    (157, 4, 13, 3, 4, 3, 4, 7, False),        # bins after the last window
    (40, 2, 5, 2, 1, 1, 40, 1, True),          # a slot and a window a bin
    (3, 1, 700, 1, 2, 2, 2, 2, False),         # rows wider than the block
])
def test_admission_window_kernel_is_bitwise_the_plain_version(
        cuda_device, t, f, c, p, n_layers, n_exp, n_slots, every, last_ctrl):
    from repro_torch.kernels import admission_window
    args = _window_case(cuda_device, t, f, c, p, n_layers, n_exp, n_slots,
                        every, last_ctrl)
    before = admission_window.launches
    got = admission_window.admission_window(*args)
    torch.cuda.synchronize()
    assert admission_window.launches == before + 1
    want = admission_window.admission_window_plain(*args)
    assert got.shape == want.shape == (args[-1], f, p)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    cpu = admission_window.admission_window_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args))
    np.testing.assert_array_equal(cpu.numpy(), want.cpu().numpy())


def test_admission_window_without_windows_launches_nothing(cuda_device):
    from repro_torch.kernels import admission_window
    args = list(_window_case(cuda_device, 9, 1, 5, 2, 2, 2, 2, 10, False))
    before = admission_window.launches
    out = admission_window.admission_window(*args)
    assert out.shape == (0, 1, 2) and admission_window.launches == before


def test_fleet_admission_runs_the_ctrl_kernel_and_matches_the_cpu(cuda_device):
    """A small fleet under AIMD admission on the card: one admission_window
    and one admission_ctrl launch per fixed-point iteration, and the CPU's
    plain versions give
    the same shed, retries and served sets and latencies."""
    from repro_torch import core
    from repro_torch.kernels import ops
    from repro_torch.traffic import (AdmissionConfig, FleetSim, QueueConfig,
                                     build_ground_segment, sample_requests)
    con = core.Constellation(core.ConstellationConfig.scaled(
        8, 12, n_slots=10, survival_prob=1.0))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 4, 4, np.random.default_rng(7))]
    ground = build_ground_segment(con, core.LinkConfig(),
                                  min_elevation_deg=10.0)
    req = sample_requests(np.random.default_rng(8), rate_rps=6.0,
                          horizon_s=40.0, n_stations=ground.n_stations,
                          prompt_median=4, prompt_max=16, decode_mean=4,
                          decode_max=8)
    qcfg = QueueConfig(dt_s=0.05, tail_s=30.0,
                       admission=AdmissionConfig(ttft_target_s=3.0))
    res = {}
    for dev in ("cuda", "cpu"):
        sim = FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                       core.ComputeConfig(), req, np.random.default_rng(5),
                       qcfg=qcfg, ground=ground, device=dev)
        ops.reset_launch_counts()
        res[dev] = sim.run()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["admission_ctrl"] == qcfg.iterations
            assert counts["admission_window"] == qcfg.iterations
            assert counts["backlog_scan"] == qcfg.iterations
            assert counts["deposit"] == qcfg.iterations - 1
    for a, b in zip(res["cpu"].plans, res["cuda"].plans):
        for name in ("served", "shed", "retries"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        np.testing.assert_allclose(b.ttft_s, a.ttft_s, rtol=1e-5,
                                   equal_nan=True)
        np.testing.assert_allclose(b.e2e_s, a.e2e_s, rtol=1e-5,
                                   equal_nan=True)
    assert any(p.shed.any() for p in res["cpu"].plans)


def _small_fleet(device, batching=None, probes=None, admission=None,
                 rate=12.0):
    """``FleetSim`` on the 8 x 12 test world (4 layers, 4 experts top-2,
    2 plans) on ``device``; with ``admission`` behind the 8 default
    gateways."""
    from repro_torch import core
    from repro_torch.traffic import (FleetSim, QueueConfig,
                                     build_ground_segment, sample_requests)
    con = core.Constellation(core.ConstellationConfig.scaled(
        8, 12, n_slots=10, survival_prob=1.0))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plans = [core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 4, 4, np.random.default_rng(7))]
    ground = None if admission is None else build_ground_segment(
        con, core.LinkConfig(), min_elevation_deg=10.0)
    n_stations = 1 if ground is None else ground.n_stations
    req = sample_requests(np.random.default_rng(8), rate_rps=rate,
                          horizon_s=40.0, n_stations=n_stations,
                          prompt_median=4, prompt_max=16, decode_mean=4,
                          decode_max=8)
    qcfg = QueueConfig(dt_s=0.05, tail_s=30.0, admission=admission)
    return FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                    core.ComputeConfig(), req, np.random.default_rng(5),
                    qcfg=qcfg, ground=ground, batching=batching,
                    probes=probes, device=device)


def _same_results(a, b):
    for pa, pb in zip(a.plans, b.plans, strict=True):
        np.testing.assert_array_equal(pb.served, pa.served)
        for name in ("ttft_s", "e2e_s", "token_total_s"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(pa, name), err_msg=name)


@pytest.mark.parametrize("window_s", [0.0, 0.15])
def test_fleet_batching_on_the_card_matches_the_cpu(cuda_device, window_s):
    """A batched run(): deposit launched three times per device iteration,
    backlog_scan once per iteration; bitwise the CPU at a window of one
    bin, within the fused-vs-legacy criterion over a wider one (the card's
    cumsum sums in another order)."""
    from repro_torch.kernels import ops
    from repro_torch.traffic import BatchingConfig
    cfg = BatchingConfig(b_max=8, window_s=window_s)
    res = {}
    for dev in ("cuda", "cpu"):
        sim = _small_fleet(dev, batching=cfg)
        ops.reset_launch_counts()
        res[dev] = sim.run()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            n = sim.qcfg.iterations
            assert counts["deposit"] == 3 * (n - 1)
            assert counts["backlog_scan"] == n
    if window_s == 0.0:
        _same_results(res["cpu"], res["cuda"])
    for a, b in zip(res["cpu"].plans, res["cuda"].plans):
        np.testing.assert_array_equal(b.served, a.served)
        np.testing.assert_allclose(b.ttft_s, a.ttft_s, rtol=1e-5,
                                   equal_nan=True)
    assert any(p.served.any() for p in res["cuda"].plans)


def test_deposit_kernel_is_bitwise_on_the_batching_tables(cuda_device):
    """The decode-work and decode-visit channels of a fleet's chunk table
    (iteration 1's bins, in the table's row grouping) through the kernel
    and through the plain version."""
    from repro_torch.kernels import deposit as dep
    from repro_torch.traffic import BatchingConfig
    sim = _small_fleet("cuda", batching=BatchingConfig(b_max=8))
    masks = np.random.default_rng(3).random((3, sim.n_requests)) < 0.7
    ct = sim.chunk_table(masks)
    n, t_bins = ct["n"], sim.n_bins
    cols = np.zeros(ct["fprow"].size, dtype=np.int64)
    cols[:n] = ct["flat0"] % t_bins
    rows = torch.from_numpy(ct["fprow"]).to(cuda_device)
    cols = torch.from_numpy(cols).to(cuda_device)
    row_ptr = torch.from_numpy(ct["row_ptr"]).to(cuda_device)
    n_rows = masks.shape[0] * sim.n_rows
    for name in ("wdec", "cntw", "work"):
        vals = torch.from_numpy(ct[name]).to(cuda_device)
        assert vals[:n].any()
        got = dep.deposit(rows, cols, vals, n_rows, t_bins, row_ptr=row_ptr)
        want = dep.deposit_plain(rows, cols, vals, n_rows, t_bins)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("kind", ["plain", "batching", "aimd-batching"])
def test_fleet_probes_on_the_card_match_the_cpu(cuda_device, kind):
    """last_probes of a probed run() on the card equal the CPU's on every
    channel, and a probes-off run() afterwards is what it was."""
    from repro_torch.obs import ProbeConfig
    from repro_torch.traffic import AdmissionConfig, BatchingConfig
    kw = dict(probes=ProbeConfig(capacity=64))
    if kind != "plain":
        kw["batching"] = BatchingConfig(b_max=8)
    if kind.startswith("aimd"):
        kw.update(admission=AdmissionConfig(ttft_target_s=3.0), rate=6.0)
    recs, runs = {}, {}
    for dev in ("cuda", "cpu"):
        sim = _small_fleet(dev, **kw)
        runs[dev] = sim.run()
        recs[dev] = sim.last_probes
        if dev == "cuda":
            sim.probes = None
            _same_results(runs[dev], sim.run())
    for name in ("bins", "backlog_s", "util_s", "drops_s", "batch_b",
                 "qhat_s", "win_s", "admit", "gw_wait_s", "ex_wait_s"):
        a, b = getattr(recs["cpu"], name), getattr(recs["cuda"], name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=name)
    _same_results(runs["cpu"], runs["cuda"])


def test_fleet_bmax1_is_bitwise_fifo_on_the_card(cuda_device):
    from repro_torch.traffic import BatchingConfig
    fifo = _small_fleet("cuda")
    one = _small_fleet("cuda", batching=BatchingConfig(b_max=1))
    masks = np.random.default_rng(2).random((3, fifo.n_requests)) < 0.6
    _same_results(fifo.run(), one.run())
    for a, b in zip(fifo.run_many(masks), one.run_many(masks)):
        _same_results(a, b)


# --------------------------------------------------------------------- #
# The joint control plane: per-entry admission tables, the gated deposit
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("t,f,c,p,n_layers,n_exp,n_slots,every", [
    (6_005, 3, 600, 1, 32, 8, 3, 10),     # the paper's schedule row, F = 3
    (2_400, 27, 96, 1, 4, 4, 10, 10),     # bench_ctrl's grid, 27 cells
    (157, 4, 13, 3, 4, 3, 4, 7),          # several plans an entry
])
def test_admission_window_kernel_per_entry_tables(cuda_device, t, f, c, p,
                                                  n_layers, n_exp, n_slots,
                                                  every):
    """Station maps per (slot, entry), (NS, F, P, ...), bitwise the plain
    version; maps that repeat one entry's give the shared-table call."""
    from repro_torch.kernels import admission_window
    args = list(_window_case(cuda_device, t, f, c, 1, n_layers, n_exp,
                             n_slots, every, False))
    rng = np.random.default_rng(4)
    args[4] = torch.from_numpy(rng.integers(
        0, c, (n_slots, f, p, n_layers))).to(cuda_device)
    args[5] = torch.from_numpy(rng.integers(
        0, c, (n_slots, f, p, n_layers * n_exp))).to(cuda_device)
    before = admission_window.launches
    got = admission_window.admission_window(*args)
    torch.cuda.synchronize()
    assert admission_window.launches == before + 1
    want = admission_window.admission_window_plain(*args)
    assert got.shape == (args[-1], f, p)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    shared = list(args)
    shared[4], shared[5] = args[4][:, 0], args[5][:, 0]
    rep = list(args)
    rep[4] = args[4][:, :1].expand_as(args[4]).contiguous()
    rep[5] = args[5][:, :1].expand_as(args[5]).contiguous()
    np.testing.assert_array_equal(
        admission_window.admission_window(*rep).cpu().numpy(),
        admission_window.admission_window(*shared).cpu().numpy())


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("n_ctrl,f,p,g", [(4096, 3, 1, 1), (480, 27, 1, 2),
                                          (333, 5, 7, 3)])
def test_admission_ctrl_kernel_per_entry_anchors(cuda_device, policy, n_ctrl,
                                                 f, p, g):
    """Anchors per entry, ttft0 (F, P, G) and tpot0 (F, P), bitwise the
    plain loop; anchors repeated over the entries (entry stride 0 against
    P * G) give the shared-anchor call."""
    from repro_torch.kernels import admission_ctrl
    args = list(_ctrl_inputs(cuda_device, n_ctrl, f, p, g, 4.0, 1.5))
    rng = np.random.default_rng(5)
    args[1] = torch.from_numpy((rng.random((f, p, g)) * 2.0)
                               .astype(np.float32)).to(cuda_device)
    args[2] = torch.from_numpy((rng.random((f, p)) * 0.5)
                               .astype(np.float32)).to(cuda_device)
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02,
                         gain=torch.ones(p, device=cuda_device))
    before = admission_ctrl.launches
    got = admission_ctrl.admission_ctrl(*args, **kw)
    torch.cuda.synchronize()
    assert admission_ctrl.launches == before + 1
    want = admission_ctrl.admission_ctrl_plain(*args, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    rep = list(args)
    rep[1] = args[1][:1].expand_as(args[1]).contiguous()
    rep[2] = args[2][:1].expand_as(args[2]).contiguous()
    shared = list(args)
    shared[1], shared[2] = args[1][0], args[2][0]
    np.testing.assert_array_equal(
        admission_ctrl.admission_ctrl(*rep, **kw).cpu().numpy(),
        admission_ctrl.admission_ctrl(*shared, **kw).cpu().numpy())


def _ctrl_world(device, admission=None):
    """bench_ctrl's world at a quarter of its trace (8 x 12, 3 plans)."""
    from repro_torch import core
    from repro_torch.traffic import FleetSim, QueueConfig, sample_requests
    con = core.Constellation(core.ConstellationConfig.scaled(
        8, 12, n_slots=10, survival_prob=1.0))
    topo = core.sample_topology(con, core.LinkConfig(),
                                np.random.default_rng(0))
    act = core.ActivationModel.zipf(4, 4, 2, seed=1)
    plans = [core.rand_intra_cg_plan(con.cfg, 4, 4, np.random.default_rng(7)),
             core.spacemoe_plan(con, topo, act),
             core.rand_intra_cg_plan(con.cfg, 4, 4,
                                     np.random.default_rng(11))]
    req = sample_requests(np.random.default_rng(2), rate_rps=20.0,
                          horizon_s=60.0, n_stations=2, prompt_median=8,
                          prompt_max=32, decode_mean=8, decode_max=16)
    qcfg = QueueConfig(dt_s=0.05, tail_s=30.0, slot_period_s=10.0,
                       buffer_s=6.0 if admission else 3.0,
                       admission=admission)
    return FleetSim(plans, topo, act, core.MoEWorkload.llama_moe_3p5b(),
                    core.ComputeConfig(), req, np.random.default_rng(5),
                    qcfg=qcfg, device=device)


def test_deposit_kernel_on_the_gated_table(cuda_device):
    """Iteration 1's deposit of the schedule row, three entries gated by
    three slot plans: the kernel on the row-grouped table (each row's
    entries in event order) bitwise the plain deposit of the event-major
    table."""
    from repro_torch.kernels import deposit as dep
    sim = _ctrl_world(cuda_device)
    ct = sim._ctrl_tables()
    n_rows, t_bins = ct["n_rows_sched"], sim.n_bins
    sp = np.random.default_rng(6).integers(0, sim.n_plans,
                                           (3, sim.n_topo_slots))
    gate = sp[:, ct["ch_slot"]] == ct["ch_plan"][None]
    vals = (ct["ch_work"] * ct["ch_fin0"])[None] * gate
    n_gate = ct["ch_work"].size
    rows = (np.arange(3)[:, None] * n_rows + ct["ch_srow"][None]).ravel()
    row_ptr = np.concatenate([(np.arange(3)[:, None] * n_gate
                               + ct["ch_row_ptr"][None, :-1]).ravel(),
                              [3 * n_gate]])
    cols = np.tile(ct["ch_bins0"], 3)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    before = dep.launches
    got = dep.deposit(t(rows), t(cols), t(vals.ravel()), 3 * n_rows, t_bins,
                      row_ptr=t(row_ptr))
    torch.cuda.synchronize()
    assert dep.launches == before + 1
    srow_of = np.searchsorted(ct["srows"], sim.ev_chunk_station)
    em = np.lexsort((sim.ev_chunk_plan,
                     sim._rep % (sim._n_events // sim.n_plans)))
    gate_em = sp[:, sim.slots[sim.ev_chunk_req[em]]] \
        == sim.ev_chunk_plan[em][None]
    want = dep.deposit_plain(
        t((np.arange(3)[:, None] * n_rows + srow_of[em][None]).ravel()),
        t(np.tile(sim._chunk_bins0[em], 3)),
        t(((sim.ev_chunk_work * sim._chunk_fin0)[em][None]
           * gate_em).ravel()), 3 * n_rows, t_bins)
    assert torch.equal(got, want)


def test_replan_grid_on_the_card_matches_the_cpu(cuda_device):
    """A 2 x 1 x 2 controller grid under AIMD through ``run_many(replan=)``
    on the card: deposit, backlog_scan, admission_window and
    admission_ctrl each launched the count the configuration implies
    (the probe's 3 iterations, then per round an on-card iteration-1
    deposit and 3 iterations), decisions bitwise the CPU's, served, shed
    and retry sets equal, latencies within the fused-vs-legacy rtol."""
    from repro_torch.kernels import ops
    from repro_torch.traffic import AdmissionConfig, ReplanConfig
    adm = AdmissionConfig(policy="aimd", ttft_target_s=60.0)
    rcfg = ReplanConfig(mode="backlog", hysteresis=0.0,
                        migration_weight_s_per_mb=0.0)
    outs = {}
    for dev in ("cuda", "cpu"):
        sim = _ctrl_world(dev, adm)
        ops.reset_launch_counts()
        outs[dev] = sim.run_many(replan=rcfg, cadences=[1, 2],
                                 ttft_targets=[30.0, 90.0],
                                 replan_rng=np.random.default_rng(4))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            n, rounds = sim.qcfg.iterations, rcfg.controller_iterations
            want = dict(deposit=(n - 1) + rounds * n,
                        backlog_scan=n + rounds * n,
                        admission_window=n + rounds * n,
                        admission_ctrl=n + rounds * n)
            assert {k: counts[k] for k in want} == want
    for a, b in zip(outs["cpu"], outs["cuda"], strict=True):
        assert np.array_equal(a.report.schedule.slot_plan,
                              b.report.schedule.slot_plan)
        for da, db in zip(a.report.decisions, b.report.decisions,
                          strict=True):
            assert (da.boundary, da.chosen, da.switched) \
                == (db.boundary, db.chosen, db.switched)
            np.testing.assert_array_equal(da.scores, db.scores)
            assert da.migration_bytes == db.migration_bytes
        for pa, pb in zip(a.result.plans, b.result.plans, strict=True):
            for name in ("served", "shed", "retries"):
                np.testing.assert_array_equal(getattr(pb, name),
                                              getattr(pa, name))
            np.testing.assert_allclose(pb.ttft_s, pa.ttft_s, rtol=1e-5,
                                       equal_nan=True)
    assert any(o.report.n_switches for o in outs["cuda"])


def _federation(device, policy="aimd"):
    """A small K = 3 federation with padded plans (2, 1, 1) behind the 8
    default gateways, AIMD or PID admission (the world of
    ``tests/test_torch_federation.py``), on ``device``."""
    from repro_torch import core
    from repro_torch.traffic import (AdmissionConfig, FleetSim, QueueConfig,
                                     build_federation, build_ground_segment,
                                     sample_requests)
    cfg = core.ConstellationConfig.scaled(8, 12, n_slots=10,
                                          survival_prob=1.0)
    req = sample_requests(np.random.default_rng(8), rate_rps=4.3,
                          horizon_s=43.0, n_stations=8, prompt_median=4,
                          prompt_max=16, decode_mean=4, decode_max=8)
    qcfg = QueueConfig(dt_s=0.05, tail_s=40.0, admission=AdmissionConfig(
        policy=policy, ttft_target_s=8.0))

    def factory(seed, n_plans):
        def build(min_bins=0):
            con = core.Constellation(cfg)
            topo = core.sample_topology(con, core.LinkConfig(),
                                        np.random.default_rng(seed))
            act = core.ActivationModel.zipf(4, 4, 2, seed=1)
            plans = [core.spacemoe_plan(con, topo, act)]
            if n_plans > 1:
                plans.append(core.rand_intra_cg_plan(
                    cfg, 4, 4, np.random.default_rng(seed)))
            return FleetSim(plans, topo, act,
                            core.MoEWorkload.llama_moe_3p5b(),
                            core.ComputeConfig(), req,
                            np.random.default_rng(5), qcfg=qcfg,
                            ground=build_ground_segment(
                                con, core.LinkConfig(),
                                min_elevation_deg=10.0),
                            min_bins=min_bins, device=device)
        return build
    fed = build_federation([factory(s, p) for s, p in
                            zip((0, 1, 2), (2, 1, 1))])
    masks = np.stack([np.ones(req.n_requests, dtype=bool),
                      np.random.default_rng(1).random(req.n_requests) < 0.6])
    return fed, masks


@pytest.mark.parametrize("policy", ["aimd", "pid"])
def test_fleet_kernels_on_the_federation_lanes(cuda_device, policy,
                                               monkeypatch):
    """The four fleet kernels on the lane-stacked, padded tables of a
    K = 3 federation under a 2-entry sweep (F = 6 lanes, every overflow
    round), each bitwise its plain version on the inputs the fixed point
    gave it."""
    from repro_torch.kernels import admission_ctrl as actl
    from repro_torch.kernels import admission_window as awin
    from repro_torch.kernels import backlog_scan as bscan
    from repro_torch.kernels import deposit as dep
    from repro_torch.traffic import admission, queueing
    seen = {k: [] for k in ("deposit", "scan", "window", "ctrl")}
    real = (queueing.deposit, queueing.backlog_scan,
            admission.admission_window, admission.admission_ctrl)

    def deposit_rec(rows, cols, vals, n_rows, n_cols, row_ptr):
        out = real[0](rows, cols, vals, n_rows, n_cols, row_ptr=row_ptr)
        seen["deposit"].append((out, dep.deposit_plain(rows, cols, vals,
                                                       n_rows, n_cols)))
        return out

    def scan_rec(work, cap, dt):
        out = real[1](work, cap, dt)
        seen["scan"].append((out, bscan.backlog_scan_plain(
            work.contiguous(), cap, dt)))
        return out

    def window_rec(*args):
        out = real[2](*args)
        seen["window"].append((out, awin.admission_window_plain(*args)))
        return out

    def ctrl_rec(win, *args, **kw):
        out = real[3](win, *args, **kw)
        seen["ctrl"].append((out, actl.admission_ctrl_plain(win, *args,
                                                            **kw)))
        return out
    monkeypatch.setattr(queueing, "deposit", deposit_rec)
    monkeypatch.setattr(queueing, "backlog_scan", scan_rec)
    monkeypatch.setattr(admission, "admission_window", window_rec)
    monkeypatch.setattr(admission, "admission_ctrl", ctrl_rec)
    fed, masks = _federation("cuda", policy)
    res = fed.run_many(masks)
    torch.cuda.synchronize()
    rounds, n_it = res[0].n_rounds, fed.sims[0].qcfg.iterations
    assert rounds > 1                        # overflow rounds exercised
    assert [len(v) for v in seen.values()] == \
        [rounds * (n_it - 1), rounds * n_it, rounds * n_it, rounds * n_it]
    for name, pairs in seen.items():
        for got, want in pairs:
            if name == "ctrl":
                assert torch.equal(torch.isnan(got), torch.isnan(want))
                ok = ~torch.isnan(got)
                assert torch.equal(got[ok].view(torch.int32),
                                   want[ok].view(torch.int32)), name
            else:
                assert torch.equal(got, want), name


def test_federation_on_the_card_matches_the_cpu(cuda_device):
    """The federation's overflow run on the card against the CPU: the same
    rounds, hops and assignments, identical served, shed and retry sets,
    latencies within the fused-vs-legacy rtol; one fixed point a round,
    each launching the kernels the configuration implies."""
    from repro_torch.kernels import ops
    outs = {}
    for dev in ("cuda", "cpu"):
        fed, masks = _federation(dev)
        ops.reset_launch_counts()
        outs[dev] = fed.run_many(masks)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            n, rounds = fed.sims[0].qcfg.iterations, outs[dev][0].n_rounds
            want = dict(deposit=rounds * (n - 1), backlog_scan=rounds * n,
                        admission_window=rounds * n,
                        admission_ctrl=rounds * n)
            assert {k: counts[k] for k in want} == want
    for a, b in zip(outs["cpu"], outs["cuda"], strict=True):
        assert a.n_rounds == b.n_rounds
        for name in ("hops", "assigned", "offered"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        for name in ("served", "shed", "retries"):
            np.testing.assert_array_equal(getattr(b.federated, name),
                                          getattr(a.federated, name))
        np.testing.assert_allclose(b.federated.ttft_s, a.federated.ttft_s,
                                   rtol=1e-5, equal_nan=True)


def test_calibrate_times_the_kernels(cuda_device):
    """``calibrate`` on the card times the CUDA kernels (their launch
    counters move) and derives a table that re-derives exactly."""
    from repro_torch.core import MoEWorkload, calibrate, verify_table
    wl = MoEWorkload(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                     d_ff_expert=512, n_experts=4, top_k=2, vocab_size=1024)
    before = (moe_gmm.launches, decode_attn.launches)
    table = calibrate("tiny", wl, ctx_len=128, batches=(1, 2), iters=1)
    assert (table.impl, table.backend) == ("cuda", "cuda")
    assert moe_gmm.launches > before[0] and decode_attn.launches > before[1]
    assert verify_table(table)
    assert all(v > 0 for v in table.measured_s["gateway_by_batch"].values())


@pytest.mark.parametrize("n,path", [(16392, "wgmma"), (16385, "fma")])
def test_gmm_kernel_past_2_31_elements(cuda_device, n, path):
    """A (16, 8192, N) bf16 expert stack of just over 2^31 elements, as
    jamba-1.5-large-398b's (16, 8192, 24576) stacks are: the last experts'
    offsets pass 2^31 on both paths (N % 8 != 0 takes the fma path), and
    the product stays the plain version's, row for row of every expert."""
    e, c, k = 16, 2, 8192
    assert e * k * n > 2 ** 31
    x, w = _gmm_inputs(cuda_device, e, c, k, n, torch.bfloat16)
    before = dict(moe_gmm.path_launches)
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.path_launches[path] == before[path] + 1
    want = moe_gmm.gmm_plain(x, w)
    del w
    scale = float(want.float().abs().max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                               **TOL[torch.bfloat16])
    assert float(got[-1].float().abs().max()) > 0.1 * scale


def test_jamba_mamba_moe_block_on_the_card_matches_the_cpu(cuda_device):
    """One Mamba + MoE block of jamba-1.5-large-398b's smoke config (f32):
    prefill of 8 tokens and three decode steps through ``_apply_block`` on
    the card (gmm on its fma path) against the same weights on the CPU,
    outputs and the carried Mamba state at 2e-4 (summation order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import (Parallel, _apply_block,
                                          _block_cache, _block_init)
    cfg = smoke_config("jamba-1.5-large-398b")
    spec = cfg.pattern[0]
    assert (spec.mixer, spec.ffn) == ("mamba", "moe")
    bp = _block_init(torch.Generator().manual_seed(0), cfg, spec,
                     torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 8, cfg.d_model, generator=gen)
    steps = torch.randn(3, 4, 1, cfg.d_model, generator=gen)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = {k: {n: v.to(dev) for n, v in sub.items()} if isinstance(sub, dict)
             else sub.to(dev) for k, sub in bp.items()}
        cache = _block_cache(cfg, spec, 4, 12, torch.float32, torch.device(dev))
        pos = torch.arange(8, dtype=torch.int32, device=dev)[None].expand(4, 8)
        ops.reset_launch_counts()
        y, cache, _ = _apply_block(cfg, spec, p, x.to(dev), pos, Parallel(),
                                   torch.float32, cache, "prefill")
        outs = [y]
        for i in range(3):
            pos = torch.full((4,), 8 + i, dtype=torch.int32, device=dev)
            y, cache, _ = _apply_block(cfg, spec, p, steps[i].to(dev), pos,
                                       Parallel(), torch.float32, cache,
                                       "decode")
            outs.append(y)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()["gmm"] == 3 * 4
        runs[dev] = ([o.cpu() for o in outs],
                     {k: v.cpu() for k, v in cache.items()})
    for got, want in zip(runs["cuda"][0], runs["cpu"][0], strict=True):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                                   rtol=2e-4)
    for k, want in runs["cpu"][1].items():
        np.testing.assert_allclose(runs["cuda"][1][k].numpy(), want.numpy(),
                                   atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------- #
# gmm's backward products (training)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("e,c,k,n", [
    (3, 40, 64, 48),          # small (C a multiple of 8: dw on wgmma)
    (40, 2048, 1536, 512),    # granite-moe-3b-a800m at batch 4 x 2048:
    (40, 2048, 512, 1536),    # gate/up and down
])
def test_gmm_backward_matches_plain_autograd(cuda_device, e, c, k, n):
    """forward, dx and dw through the kernel against autograd through
    ``gmm_plain`` on the card, each within 2^-7 of its largest value (one
    bf16 rounding of each, 2^-8 relative); three launches, all wgmma."""
    x, w = _gmm_inputs(cuda_device, e, c, k, n, torch.bfloat16, seed=4)
    w = (w.float() / k ** 0.5).to(torch.bfloat16)
    dy = torch.randn(e, c, n, device=cuda_device).to(torch.bfloat16)
    runs = []
    for fn in (moe_gmm.gmm, moe_gmm.gmm_plain):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = dict(moe_gmm.path_launches)
        y = fn(xr, wr)
        y.backward(dy)
        torch.cuda.synchronize()
        runs.append(([y.detach(), xr.grad, wr.grad],
                     {p: moe_gmm.path_launches[p] - before[p] for p in before}))
    (got, paths), (want, plain_paths) = runs
    assert paths == {"wgmma": 3, "fma": 0}
    assert plain_paths == {"wgmma": 0, "fma": 0}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        assert err <= scale * 2.0 ** -7, (err, scale)


def test_gmm_backward_raises_rather_than_falling_back(cuda_device, monkeypatch):
    """A failed launch in the backward raises; ``gmm_plain`` is never run
    for CUDA tensors, and serve's no-grad call builds no autograd node."""
    x, w = _gmm_inputs(cuda_device, 4, 8, 64, 64, torch.bfloat16)
    with torch.no_grad():
        assert moe_gmm.gmm(x, w).grad_fn is None
    xr = x.clone().requires_grad_(True)
    y = moe_gmm.gmm(xr, w)
    assert type(y.grad_fn).__name__ == "GmmFunctionBackward"

    class Failing:
        @staticmethod
        def repro_gmm(*args):
            return 700                  # cudaErrorIllegalAddress

    def plain(*args):
        raise AssertionError("gmm_plain must not run for CUDA tensors")
    monkeypatch.setattr(moe_gmm, "_library", lambda: Failing)
    monkeypatch.setattr(moe_gmm, "gmm_plain", plain)
    before = moe_gmm.launches
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        y.sum().backward()
    assert moe_gmm.launches == before


def test_granite_smoke_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Three train steps of granite's smoke model (f32, so gmm's fma
    path) on the card against the CPU: losses within rtol 1e-5, params
    within atol 1e-4 (index-put backwards sum with atomics on the card,
    in another order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Parallel, init_params
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_config("granite-moe-3b-a800m")
    master = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         cast=False)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                .astype(np.int32)) for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda p: p.clone().to(dev), master)
        state = adamw_init(params)
        step = make_train_step(cfg, Parallel(), AdamWConfig(lr=1e-2),
                               cosine_schedule(1, 3))
        ops.reset_launch_counts()
        losses = []
        for toks in batches:
            toks = toks.to(dev)
            params, state, met = step(params, state,
                                      {"tokens": toks, "labels": toks})
            losses.append(float(met["loss"]))
        out[dev] = (losses, params, ops.launch_counts()["gmm"])
    assert out["cpu"][2] == 0
    assert out["cuda"][2] == 3 * 2 * 12      # 2 MoE layers x (3 + 3 + 6)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(tree_leaves(out["cuda"][1]), tree_leaves(out["cpu"][1])):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4, rtol=1e-4)
