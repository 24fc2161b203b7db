"""The designs of the port's decode_attention, backlog_scan, deposit,
admission_ctrl and admission_window kernels, on the CPU.

The CUDA kernels run only on a card.  What their designs rest on is
checked here with plain PyTorch emulations of the same algorithms:

  * backlog_scan cuts T into chunks, runs each from 0 (lo) and from
    U = max(cap - dt, 0) (hi), trusts both from the first bin where they
    agree bit for bit, and fills the bins before it from the previous
    chunk's exact end.  The emulation is held bitwise to the plain loop
    under hypothesis, over chunk sizes, caps, bin widths and work that
    coalesces, never does, or sits at cap <= dt.
  * decode_attention splits S over blocks (``decode_splits``), runs an
    online softmax per tile of rows, and merges the splits' (m, l, acc)
    in split order.  The emulation is held to the plain version and to
    the JAX reference's Pallas kernel in interpret mode.
  * deposit buckets each row's triples stably by tile (a count pass and
    a scatter pass per warp stretch, cursors scanned in (tile, warp)
    order), then sums each (row, tile) bucket in 32-entry steps: single
    lanes at once, lanes on one cell by their lowest lane in lane order,
    a step all on one cell as one chain, zero-valued entries skipped.
    The emulation is held bitwise to the plain version under hypothesis.
  * admission_ctrl cuts each cell's control bins into chunks, runs each
    from both ends of the state's bracket, trusts the lower run from the
    first bin where the two agree bit for bit, walks the chunks in order
    for their exact starts (a NaN start stays NaN) and re-runs the bins
    before the meeting point.  The emulation is held bitwise to the plain
    loop under hypothesis (AIMD and PID, NaN windows, infinite targets,
    admit0 outside [admit_min, 1]) and on windows that never coalesce.
  * admission_window stages the rows after a tile of bins, takes each
    layer's gateway term and expert maximum, then the sums over layers
    in order, and the window maxima on the f32 bit patterns.  The
    emulation is held bitwise to the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ops import decode_attention as jax_decode_attention
from repro_torch.kernels import admission_ctrl as ctrl_mod
from repro_torch.kernels import admission_window as window_mod
from repro_torch.kernels import backlog_scan, decode_attn, deposit

SMS = 132      # streaming multiprocessors of an H100 SXM, the pinned card

# --------------------------------------------------------------------- #
# backlog_scan: the chunked lo/hi scan and its fix-up
# --------------------------------------------------------------------- #


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def chunked_scan(work: torch.Tensor, cap: float, dt: float, chunk: int):
    """The kernel's algorithm in plain PyTorch, one chunk after another
    (every column at once).  Returns (wait, coal): coal[k, c] is the bins
    chunk k's runs took to meet in column c, -1 when they never did."""
    n_bins, n_cols = work.shape
    cap_t = torch.tensor(cap, dtype=torch.float32)
    dt_t = torch.tensor(dt, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)

    def step(b, w):
        return torch.maximum(torch.minimum(b + w, cap_t) - dt_t, zero)

    u = torch.maximum(cap_t - dt_t, zero)
    wait = torch.full_like(work, float("nan"))
    coal, end = [], None
    for k, t0 in enumerate(range(0, n_bins, chunk)):
        t1 = min(t0 + chunk, n_bins)
        lo = torch.zeros(n_cols)
        hi = torch.zeros(n_cols) if k == 0 else u.expand(n_cols).clone()
        met = torch.zeros(n_cols, dtype=torch.bool)
        tc = torch.full((n_cols,), t1)
        for t in range(t0, t1):
            # lo <= the true backlog <= hi, in every bin (monotonicity)
            assert bool((lo <= hi).all())
            now = ~met & (_bits(lo) == _bits(hi))
            tc[now] = t
            met |= now
            wait[t, met] = lo[met]
            lo, hi = step(lo, work[t]), step(hi, work[t])
        met |= _bits(lo) == _bits(hi)
        coal.append(torch.where(met, tc - t0, -1))
        # The fix-up: from the previous chunk's exact end to the
        # coalescence bin (chunk 0 starts exactly from 0 and has met).
        stop = torch.where(met, tc, t1)
        x = torch.zeros(n_cols) if k == 0 else end
        for t in range(t0, t1):
            todo = t < stop
            wait[t, todo] = x[todo]
            x = step(x, work[t])
        end = torch.where(met, lo, x)
    return wait, torch.stack(coal)


def _work(mode: str, n_bins: int, n_cols: int, dt: float, seed: int):
    rng = np.random.default_rng(seed)
    if mode == "sparse":          # mostly idle, short bursts
        w = rng.random((n_bins, n_cols)) * (rng.random((n_bins, n_cols)) < 0.1)
    elif mode == "heavy":         # overflows the cap
        w = rng.random((n_bins, n_cols)) * 3.0
    elif mode == "zero":
        w = np.zeros((n_bins, n_cols))
    elif mode == "never":         # b strictly inside (0, U): lo and hi never meet
        w = np.full((n_bins, n_cols), dt)
        w[0] = 0.5
    else:                         # a mix of the above, column by column
        w = np.stack([_work(m, n_bins, 1, dt, seed + i)[:, 0].numpy()
                      for i, m in zip(range(n_cols),
                                      ["sparse", "heavy", "zero", "never"] * n_cols)],
                     axis=1)
    return torch.from_numpy(np.asarray(w, np.float32))


@settings(max_examples=40, deadline=None)
@given(n_bins=st.integers(1, 120), n_cols=st.integers(1, 5),
       chunk=st.integers(1, 50),
       cap=st.sampled_from([0.0, 0.01, 0.05, 0.3, 1.0, 10.0]),
       dt=st.sampled_from([0.05, 0.01, 0.3]),
       mode=st.sampled_from(["sparse", "heavy", "zero", "never", "mixed"]),
       seed=st.integers(0, 2 ** 31))
def test_chunked_scan_is_bitwise_the_plain_loop(n_bins, n_cols, chunk, cap, dt,
                                                mode, seed):
    work = _work(mode, n_bins, n_cols, dt, seed)
    got, coal = chunked_scan(work, cap, dt, chunk)
    assert torch.equal(got, backlog_scan.backlog_scan_plain(work, cap, dt))
    assert bool((coal[0] == 0).all())            # chunk 0 starts exactly


@pytest.mark.parametrize("chunk", [1, 7, 16, 64])
def test_chunk_that_never_coalesces_is_exact(chunk):
    """Every chunk after the first re-runs whole from its exact start."""
    work = _work("never", 200, 3, 0.05, 0)
    got, coal = chunked_scan(work, 1.0, 0.05, chunk)
    assert torch.equal(got, backlog_scan.backlog_scan_plain(work, 1.0, 0.05))
    assert bool((coal[1:] == -1).all())
    assert bool(((got[1:] > 0) & (got[1:] < 0.95)).all())


@pytest.mark.parametrize("cap", [0.02, 0.05])
def test_cap_at_or_below_dt_coalesces_at_once(cap):
    """U = max(cap - dt, 0) = 0: lo and hi start equal in every chunk."""
    work = _work("heavy", 150, 4, 0.05, 1)
    got, coal = chunked_scan(work, cap, 0.05, 32)
    assert torch.equal(got, backlog_scan.backlog_scan_plain(work, cap, 0.05))
    assert bool((coal == 0).all())


def test_idle_columns_coalesce_after_the_buffer_drains():
    """A full buffer U drains by dt a bin: ceil(U / dt) bins to meet lo."""
    work = torch.zeros(600, 2)
    _, coal = chunked_scan(work, 10.0, 0.05, 300)
    assert coal[1].tolist() == [199, 199]


@pytest.mark.parametrize("n_bins,n_cols,want", [
    (40_966, 864, 1024),     # FleetSim.run() on the paper's world
    (40_966, 9_504, 4096),   # run_many over 11 fractions
    (3000, 700, 1024),
    (1, 1, 1024),
])
def test_scan_chunk_pinned(n_bins, n_cols, want):
    assert backlog_scan.scan_chunk(n_bins, n_cols, SMS) == want


def test_scan_chunk_gives_every_sm_blocks_on_the_run_plane():
    chunk = backlog_scan.scan_chunk(40_966, 864, SMS)
    blocks = -(-864 // backlog_scan.TILE_COLS) * -(-40_966 // chunk)
    assert blocks >= backlog_scan.WARPS_PER_SM * SMS


def test_coalescence_report_needs_the_kernel():
    with pytest.raises(ValueError, match="CUDA"):
        backlog_scan.backlog_scan(torch.ones(5, 3), 10.0, 0.05,
                                  coalescence=torch.zeros(1, 3,
                                                          dtype=torch.int32))


# --------------------------------------------------------------------- #
# decode_attention: split S, online softmax per tile, in-launch combine
# --------------------------------------------------------------------- #


def tile_rows(hd: int, esize: int) -> int:
    """Rows of a kernel tile: 16 KB of K and V rows, hd in its bucket."""
    bucket = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return 512 // (bucket * esize // 16)


def split_attention(q, k, v, pos, tile):
    """The kernel's algorithm in plain PyTorch (f32): per split of
    ``decode_splits`` rows, an online softmax with one max and one
    rescale per tile; then the splits merged in split order."""
    b, hkv, g, hd = q.shape
    s = k.shape[2]
    n_split, chunk = decode_attn.decode_splits(b, hkv, s, SMS)
    scale = hd ** -0.5
    out = torch.empty(b, hkv, g, hd)
    for bi in range(b):
        last = min(int(pos[bi]), s - 1)
        for h in range(hkv):
            qf = q[bi, h].float()
            parts = []
            for sp in range(n_split):
                r0, r1 = sp * chunk, min(sp * chunk + chunk, last + 1)
                m = torch.full((g,), decode_attn.NEG_INF)
                l, acc = torch.zeros(g), torch.zeros(g, hd)
                for t0 in range(r0, r1, tile):
                    rows = slice(t0, min(t0 + tile, r1))
                    sc = qf @ k[bi, h, rows].float().T * scale      # (g, rows)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    p = torch.exp(sc - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=1)
                    acc = acc * corr[:, None] + p @ v[bi, h, rows].float()
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).max(dim=0).values
            lt, ot = torch.zeros(g), torch.zeros(g, hd)
            for m, l, acc in parts:
                if bool((l > 0).any()):                  # empty partials skip
                    w = torch.exp(m - mx)
                    lt = lt + l * w
                    ot = ot + acc * w[:, None]
            out[bi, h] = ot / torch.clamp_min(lt, 1e-30)[:, None]
    return out.to(q.dtype)


def _attn_inputs(b, hkv, g, s, hd, pos, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


@pytest.mark.parametrize("b,hkv,s,want", [
    (4, 32, 49, (1, 64)),        # the serve path: one split, no combine
    (4, 32, 2048, (8, 256)),     # a long cache: 1024 blocks on 132 SMs
    (4, 32, 63, (1, 64)),
    (1, 2, 2048, (32, 64)),      # few heads: as many splits as chunks allow
    (2, 2, 333, (3, 128)),
])
def test_decode_splits_pinned(b, hkv, s, want):
    assert decode_attn.decode_splits(b, hkv, s, SMS) == want


@pytest.mark.parametrize("b,hkv,s", [(4, 32, 2048), (1, 8, 4096), (8, 32, 512)])
def test_decode_splits_fill_the_card_in_whole_chunks(b, hkv, s):
    n_split, chunk = decode_attn.decode_splits(b, hkv, s, SMS)
    assert b * hkv * n_split >= 2 * SMS
    assert chunk % decode_attn.MIN_CHUNK == 0
    assert (n_split - 1) * chunk < s <= n_split * chunk


@pytest.mark.parametrize("b,hkv,g,s,hd,pos", [
    (2, 2, 3, 333, 64, [332, 100]),               # G = 3, pos in split 0 and 2
    (1, 2, 1, 300, 32, [255]),                    # a split ends at pos
    (5, 1, 6, 400, 64, [0, 399, 127, 128, 129]),  # pos at 0, S-1 and a boundary
    (1, 1, 2, 49, 128, [48]),                     # one split
])
def test_split_attention_matches_plain(b, hkv, g, s, hd, pos):
    q, k, v, p = (torch.from_numpy(a) for a in _attn_inputs(b, hkv, g, s, hd, pos))
    want = decode_attn.decode_attention_plain(q, k, v, p)
    got = split_attention(q, k, v, p, tile_rows(hd, 4))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,hkv,g,s,hd,pos,bs", [
    (2, 2, 3, 333, 64, [332, 150], 128),
    (1, 2, 1, 300, 32, [299], 64),
])
def test_split_attention_matches_reference(b, hkv, g, s, hd, pos, bs):
    """The same numpy inputs through the JAX reference's Pallas kernel
    (interpret mode) and the split-S emulation."""
    arrays = _attn_inputs(b, hkv, g, s, hd, pos, seed=4)
    assert decode_attn.decode_splits(b, hkv, s, SMS)[0] > 1
    got = split_attention(*(torch.from_numpy(a) for a in arrays),
                          tile_rows(hd, 4))
    pallas = jax_decode_attention(*(jnp.asarray(a) for a in arrays),
                                  block_s=bs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               atol=2e-5, rtol=2e-5)


# --------------------------------------------------------------------- #
# deposit: bucket by (row, tile), then one warp per bucket
# --------------------------------------------------------------------- #

def bucket_row(cols: np.ndarray, n_cols: int, warps: int | None = None):
    """Launch 1 for one row (``cols`` its bins in table order): the row's
    in-range entries in bucket order (positions in the row) and each
    tile's bucket end.  Warp w of ``warps`` (``bucket_warps``) takes the
    w-th stretch of ``span`` entries; a count pass, an exclusive scan of
    the (warp, tile) counts in (tile, warp) order, then a scatter pass,
    32 lanes a step, each lane to its warp's cursor for its tile plus
    its rank among the step's lanes on that tile."""
    n, k = cols.size, deposit.deposit_tiles(n_cols)
    warps = deposit.bucket_warps(n_cols) if warps is None else warps
    span = -(-n // (32 * warps)) * 32
    stretches = [(min(n, w * span), min(n, w * span + span))
                 for w in range(warps)]
    ok = (cols >= 0) & (cols < n_cols)
    tile = np.where(ok, cols // deposit.TILE, -1)
    cnt = np.zeros((warps, k), np.int64)
    for w, (lo, hi) in enumerate(stretches):
        np.add.at(cnt[w], tile[lo:hi][ok[lo:hi]], 1)
    flat = cnt.T.reshape(-1)                           # (tile, warp) order
    cur = (np.cumsum(flat) - flat).reshape(k, warps).T.copy()
    ends = np.append(cur[0, 1:], flat.sum())
    order = np.full(int(flat.sum()), -1, np.int64)
    for w, (lo, hi) in enumerate(stretches):
        for j0 in range(lo, hi, 32):
            lanes = np.arange(j0, min(j0 + 32, hi))
            for t in np.unique(tile[lanes][ok[lanes]]):
                mine = lanes[ok[lanes] & (tile[lanes] == t)]    # lane order
                order[cur[w, t]:cur[w, t] + mine.size] = mine
                cur[w, t] += mine.size
    assert (order >= 0).all()
    return order, ends


def accumulate_bucket(bins: np.ndarray, vals: np.ndarray, paths: dict):
    """Launch 2 for one (row, tile) bucket: the tile's sums, 32 entries a
    step; ``paths`` counts the steps each branch took."""
    acc = np.zeros(deposit.TILE)                        # +0.0 everywhere
    for j0 in range(0, bins.size, 32):
        b, v = bins[j0:j0 + 32], vals[j0:j0 + 32]
        ok = v != 0.0                                   # zero-valued: skipped
        if b.size == 32 and ok.all() and (b == b[0]).all():
            s = acc[b[0]]                               # a pile: one chain
            for x in v:
                s = s + x
            acc[b[0]] = s
            paths["pile"] += 1
            continue
        keys, counts = np.unique(b[ok], return_counts=True)
        for key in keys:
            lanes = np.flatnonzero(ok & (b == key))     # lane order
            s = acc[key]
            for lane in lanes:
                s = s + v[lane]
            acc[key] = s
        paths["shared" if (counts > 1).any() else "single"] += 1
    return acc


def bucketed_deposit(cols, vals, row_ptr, n_rows: int, n_cols: int,
                     paths: dict | None = None,
                     warps: int | None = None) -> torch.Tensor:
    """The kernel's algorithm on a row-grouped table; entries from
    ``row_ptr[-1]`` on are not read."""
    paths = {"pile": 0, "shared": 0, "single": 0} if paths is None else paths
    out = np.full((n_rows, n_cols), np.nan)
    k = deposit.deposit_tiles(n_cols)
    for r in range(n_rows):
        lo, hi = int(row_ptr[r]), int(row_ptr[r + 1])
        order, ends = bucket_row(cols[lo:hi], n_cols, warps)
        starts = np.concatenate([[0], ends[:-1]])
        for t in range(k):
            sel = order[starts[t]:ends[t]] + lo
            acc = accumulate_bucket(cols[sel] - t * deposit.TILE, vals[sel],
                                    paths)
            c0 = t * deposit.TILE
            out[r, c0:c0 + deposit.TILE] = acc[:min(deposit.TILE, n_cols - c0)]
    assert not np.isnan(out).any()              # every cell written once
    return torch.from_numpy(out)


# Values whose f64 sums depend on the order, signed zeros among them.
_VALUES = [0.0, -0.0, 1.0, 3.0, 0.05, 1e16, -1e16, 1e-300, -2.5, 7e-17]


def _fleet_like_table(rng, n_rows, n_cols, sizes, mode):
    """A row-grouped table: ``sizes`` triples a row, each event's chunks
    on neighbouring bins, plus a zero-valued padding tail."""
    cols, vals = [], []
    for size in sizes:
        c = np.empty(size, np.int64)
        j = 0
        while j < size:                       # events of 1-4 chunks
            m = min(size - j, int(rng.integers(1, 5)))
            c[j:j + m] = rng.integers(0, n_cols) + np.arange(m)
            j += m
        c = np.minimum(c, n_cols - 1)
        v = np.asarray(_VALUES)[rng.integers(0, len(_VALUES), size)]
        if mode == "pile":                    # past the horizon: bin T - 1
            c[rng.random(size) < 0.6] = n_cols - 1
        elif mode == "hot":                   # one cell takes most triples
            c[rng.random(size) < 0.8] = min(n_cols - 1, 700)
        elif mode == "nonfinite":             # zero-valued triples on bin 0
            hit = rng.random(size) < 0.4
            c[hit], v[hit] = 0, 0.0
        cols.append(c)
        vals.append(v)
    row_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(row_ptr[-1])
    pad = int(rng.integers(0, 300))
    rows = np.concatenate([np.repeat(np.arange(n_rows), sizes),
                           np.zeros(pad, np.int64)])
    cols = np.concatenate(cols + [rng.integers(0, n_cols, pad)])
    vals = np.concatenate(vals + [np.zeros(pad)])
    return rows, cols, vals, row_ptr, n


@st.composite
def _deposit_case(draw):
    n_rows = draw(st.integers(1, 5))
    n_cols = draw(st.sampled_from([1, 7, 511, 512, 513, 1100, 2600]))
    shape = draw(st.sampled_from(["even", "one_big", "empty_rows"]))
    size = draw(st.integers(0, 700))
    if shape == "even":
        sizes = [size] * n_rows
    elif shape == "one_big":                  # one row holds most of the table
        sizes = [draw(st.integers(0, 20)) for _ in range(n_rows)]
        sizes[draw(st.integers(0, n_rows - 1))] = 2000 + size
    else:
        sizes = [size if draw(st.booleans()) else 0 for _ in range(n_rows)]
    mode = draw(st.sampled_from(["spread", "pile", "hot", "nonfinite"]))
    warps = draw(st.sampled_from([8, 16]))    # both block widths of launch 1
    return n_rows, n_cols, sizes, mode, warps, draw(st.integers(0, 2 ** 31))


@settings(max_examples=40, deadline=None)
@given(case=_deposit_case())
def test_bucketed_deposit_is_bitwise_the_plain_version(case):
    n_rows, n_cols, sizes, mode, warps, seed = case
    rows, cols, vals, row_ptr, n = _fleet_like_table(
        np.random.default_rng(seed), n_rows, n_cols, sizes, mode)
    got = bucketed_deposit(cols, vals, row_ptr, n_rows, n_cols, warps=warps)
    want = deposit.deposit_plain(torch.from_numpy(rows), torch.from_numpy(cols),
                                 torch.from_numpy(vals), n_rows, n_cols)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_cell_with_thousands_of_triples_runs_as_piles():
    """4000 triples on one cell: 125 steps of 32 on the pile path, and
    the sum is the in-order one."""
    rng = np.random.default_rng(5)
    vals = np.asarray(_VALUES)[rng.integers(0, len(_VALUES), 4000)]
    vals[vals == 0.0] = 1.0
    cols = np.full(4000, 513, np.int64)
    paths = {"pile": 0, "shared": 0, "single": 0}
    got = bucketed_deposit(cols, vals, np.array([0, 4000]), 1, 1100, paths)
    want = deposit.deposit_plain(torch.zeros(4000, dtype=torch.int64),
                                 torch.from_numpy(cols), torch.from_numpy(vals),
                                 1, 1100)
    assert paths == {"pile": 125, "shared": 0, "single": 0}
    assert torch.equal(got, want)
    acc = 0.0
    for v in vals:
        acc += v
    assert got[0, 513].item() == acc


@pytest.mark.parametrize("warps", [8, 16])
def test_buckets_keep_table_order_across_warp_stretches(warps):
    """One tile's entries spread over every warp's stretch: the bucket
    lists them in table order."""
    cols = np.tile(np.array([5, 600, 5, 1200]), 700)        # 2800 entries
    order, ends = bucket_row(cols, 1300, warps)
    assert ends.tolist() == [1400, 2100, 2800]
    for lo, hi in ((0, 1400), (1400, 2100), (2100, 2800)):
        assert (np.diff(order[lo:hi]) > 0).all()


def test_out_of_range_bins_are_not_bucketed():
    order, ends = bucket_row(np.array([3, -1, 9, 2, 12]), 10)
    assert order.tolist() == [0, 2, 3] and ends.tolist() == [3]


@pytest.mark.parametrize("n_cols,want", [
    (40_966, 81),            # FleetSim.run() on the paper's world
    (512, 1), (513, 2), (1, 1),
    (2_000_000, 3907),       # the most bins FleetSim allows
])
def test_deposit_tiles_pinned(n_cols, want):
    assert deposit.deposit_tiles(n_cols) == want
    assert want <= deposit.MAX_TILES


@pytest.mark.parametrize("n_cols,want", [
    (40_966, 16),            # the fleet's T: 16 warps a row
    (1, 16),
    (3584 * 512, 16),
    (3584 * 512 + 1, 8),     # 16 warps' counters would pass 227 KB
    (2_000_000, 8),
])
def test_bucket_warps_pinned(n_cols, want):
    assert deposit.bucket_warps(n_cols) == want
    assert want * 4 * deposit.deposit_tiles(n_cols) <= 232_448 - 64


@pytest.mark.parametrize("n,n_rows,n_cols,want", [
    (5_414_912, 864, 40_966, 54_709_008),    # run()'s table, padding included
    (0, 3, 10, 40),
])
def test_deposit_scratch_bytes_pinned(n, n_rows, n_cols, want):
    assert deposit.scratch_bytes(n, n_rows, n_cols) == want


def test_deposit_takes_every_horizon_the_fleet_allows():
    """MAX_TILES * TILE bins fit the bucket pass's shared counters (8
    warps x 4 bytes a tile, 227 KB at most) and cover FleetSim's 2 M."""
    assert 8 * 4 * deposit.MAX_TILES <= 232_448 - 64
    assert deposit.MAX_TILES * deposit.TILE >= 2_000_000


# --------------------------------------------------------------------- #
# admission_ctrl: the chunked bracket scan over control bins
# --------------------------------------------------------------------- #

NAN = float("nan")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, except that any NaN equals any NaN (the kernel's
    min/max give the canonical NaN, torch's keep an input's)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(
        torch.equal(_bits(a)[~nan_a], _bits(b)[~nan_b]))


class _Cell:
    """The AIMD / PID cell of ``admission_ctrl_plain`` for every (f, p, g)
    at once, one step a call, in the plain loop's f32 operations."""

    def __init__(self, ttft0, tpot0, ttft_target, tpot_target, *, increase,
                 decrease, admit_min, pid):
        def s(x):
            return torch.tensor(float(np.float32(x)), dtype=torch.float32)
        self.ttft0, self.tpot0 = ttft0[None], tpot0[None]
        self.tt, self.tp = ttft_target[:, None, None], tpot_target[:, None]
        self.one, self.inf, self.amin = s(1.0), s(float("inf")), s(admit_min)
        self.inc, self.dec = s(increase), s(decrease)
        self.pid = pid
        if pid is not None:
            self.kp, self.ki, self.kd = s(pid["kp"]), s(pid["ki"]), s(pid["kd"])
            self.gain = pid["gain"][None, :, None]
            self.w = s(ctrl_mod.PID_WINDUP)

    def aimd(self, admit, w):
        over = ((self.ttft0 + w[..., None]) > self.tt) \
            | ((self.tpot0 + w) > self.tp)[..., None]
        return torch.where(over, torch.maximum(admit * self.dec, self.amin),
                           torch.minimum(admit + self.inc, self.one))

    def err(self, w):
        h_t = torch.where(torch.isfinite(self.tt),
                          (self.tt - (self.ttft0 + w[..., None])) / self.tt,
                          self.inf)
        h_p = torch.where(torch.isfinite(self.tp),
                          (self.tp - (self.tpot0 + w)) / self.tp,
                          self.inf)[..., None]
        return torch.minimum(h_t, h_p)

    def integ(self, integ, err):
        return torch.minimum(torch.maximum(integ + err, -self.w), self.w)

    def admit_pid(self, admit, err, integ, prev):
        delta = self.kp * err + self.ki * integ + self.kd * (err - prev)
        return torch.minimum(torch.maximum(admit + self.gain * delta,
                                           self.amin), self.one)

    def run(self, state, win, prev, out=None, stop=None):
        """The exact cell from ``state`` ((integ, admit)) over the rows of
        ``win``; writes ``out[i]`` where i < ``stop``.  Returns the state
        after the last row."""
        integ, admit = state
        for i in range(win.shape[0]):
            if self.pid is None:
                admit = self.aimd(admit, win[i])
            else:
                e = self.err(win[i])
                integ = self.integ(integ, e)
                admit = self.admit_pid(admit, e, integ, prev)
                prev = e
            if out is not None:
                todo = i < stop
                out[i][todo] = admit[todo]
        return integ, admit


def chunked_ctrl(win, ttft0, tpot0, admit0, ttft_target, tpot_target, *,
                 chunk, **kw):
    """``csrc/admission_ctrl.cu``'s algorithm in plain PyTorch, every cell
    at once.  Returns (out, coal): coal[j] is the bins chunk j's bracket
    runs took to meet in each cell, -1 where they never did.

    Pass 1 runs each chunk from both ends of its bracket and keeps the
    lower run from the first bin where the two agree bit for bit.  The
    walk takes the chunks in order: a chunk whose runs met ends at the
    lower run's end (NaN if it starts at NaN, which every step keeps),
    any other is run from its exact start.  Pass 2 runs each chunk from
    its exact start up to where its runs met (all of it if they never
    did, or if it starts at NaN)."""
    cell = _Cell(ttft0, tpot0, ttft_target, tpot_target, **kw)
    pid = kw["pid"] is not None
    n_ctrl = win.shape[0]
    shape = admit0.shape
    out = torch.full((n_ctrl,) + shape, -7.0)
    zero, nan = torch.zeros(shape), torch.full(shape, NAN)
    amin, one = cell.amin.expand(shape), cell.one.expand(shape)
    chunks = range(0, n_ctrl, chunk)
    ends, coal, prevs = [], [], []
    for j, k0 in enumerate(chunks):
        k1 = min(k0 + chunk, n_ctrl)
        prev = zero if k0 == 0 or not pid else cell.err(win[k0 - 1])
        prevs.append(prev)
        if k0 == 0:                    # chunk 0 starts exactly
            lo = hi = admit0
            ilo = ihi = zero
        elif pid:                      # after a step: [amin, 1], [-W, W]
            lo, hi = amin, one
            ilo, ihi = -cell.w.expand(shape), cell.w.expand(shape)
        else:                          # [min(admit0, amin), max(admit0, 1)]
            lo, hi = torch.fmin(admit0, cell.amin), torch.fmax(admit0, one)
        imet = _bits(ilo) == _bits(ihi)
        met = torch.zeros(shape, dtype=torch.bool)
        tc = torch.full(shape, -1)
        for i, k in enumerate(range(k0, k1)):
            # lo <= the true state <= hi while it is not NaN (monotonicity)
            if pid:
                e = cell.err(win[k])
                ilo, ihi = cell.integ(ilo, e), cell.integ(ihi, e)
                imet |= _bits(ilo) == _bits(ihi)
                # admit moves only once the integral is known exactly
                lo = torch.where(imet, cell.admit_pid(lo, e, ilo, prev), lo)
                hi = torch.where(imet, cell.admit_pid(hi, e, ilo, prev), hi)
                prev = e
            else:
                lo, hi = cell.aimd(lo, win[k]), cell.aimd(hi, win[k])
            now = ~met & imet & (_bits(lo) == _bits(hi))
            tc[now] = i
            met |= now
            out[k][met] = lo[met]
        coal.append(tc)
        ends.append((ilo, lo))
    # the walk: each chunk's exact start
    state, starts = (zero, admit0), []
    for j, k0 in enumerate(chunks):
        starts.append(state)
        k1 = min(k0 + chunk, n_ctrl)
        dead = torch.isnan(state[1])
        run = cell.run(state, win[k0:k1], prevs[j])
        met = coal[j] >= 0
        state = tuple(torch.where(met, torch.where(dead, nan, c), r)
                      for c, r in zip(ends[j], run))
    # pass 2: the bins before the runs met, from the exact start
    for j, k0 in enumerate(chunks):
        k1 = min(k0 + chunk, n_ctrl)
        stop = torch.where((coal[j] >= 0) & ~torch.isnan(starts[j][1]),
                           coal[j], k1 - k0)
        cell.run(starts[j], win[k0:k1], prevs[j], out=out[k0:k1], stop=stop)
    return out, torch.stack(coal) if coal else torch.empty((0,) + shape)


def _ctrl_case(rng, n_ctrl, f, p, g, policy, targets, nan_share, admit0):
    win = rng.gamma(0.6, 3.0, (n_ctrl, f, p)) \
        * (rng.random((n_ctrl, f, p)) < 0.7)
    win[rng.random(win.shape) < nan_share] = np.nan
    tt = {"finite": rng.uniform(2.0, 6.0, f), "ttft inf": np.full(f, np.inf),
          "both inf": np.full(f, np.inf)}[targets]
    tp = np.full(f, np.inf) if targets == "both inf" \
        else rng.uniform(0.5, 2.0, f)
    a0 = {"ones": np.ones((f, p, g)),
          "mixed": rng.choice([0.0, 0.01, 0.3, 1.0, 1.7, 40.0, -2.0],
                              (f, p, g)),
          "extreme": rng.choice([np.inf, -np.inf, np.nan, 0.5], (f, p, g))
          }[admit0]

    def t32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))
    args = (t32(win), t32(rng.random((p, g)) * 2.0), t32(rng.random(p) * 0.5),
            t32(a0), t32(tt), t32(tp))
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "pid":
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=float(rng.choice([0.0, 0.02])),
                         gain=t32(rng.uniform(0.5, 2.0, p)))
    return args, kw


@settings(max_examples=60, deadline=None)
@given(policy=st.sampled_from(["aimd", "pid"]),
       n_ctrl=st.integers(1, 150), chunk=st.sampled_from([1, 7, 64]),
       f=st.integers(1, 2), p=st.integers(1, 3), g=st.integers(1, 3),
       targets=st.sampled_from(["finite", "ttft inf", "both inf"]),
       nan_share=st.sampled_from([0.0, 0.0, 0.05]),
       admit0=st.sampled_from(["ones", "mixed", "extreme"]),
       seed=st.integers(0, 2 ** 31))
def test_chunked_ctrl_is_bitwise_the_plain_loop(policy, n_ctrl, chunk, f, p,
                                                g, targets, nan_share, admit0,
                                                seed):
    args, kw = _ctrl_case(np.random.default_rng(seed), n_ctrl, f, p, g,
                          policy, targets, nan_share, admit0)
    got, coal = chunked_ctrl(*args, chunk=chunk, **kw)
    want = ctrl_mod.admission_ctrl_plain(*args, **kw)
    assert _same_bits(got, want)
    assert bool((coal[0] == 0).all())            # chunk 0 starts exactly


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_ctrl_on_fleet_like_windows_coalesces_early(policy, chunk):
    """Windows all over or all under the target (the paper's world at
    30 s, and at 1.5 to 5 x its zero-load p99): every chunk long enough
    to hold them sees its runs meet within its first few bins (AIMD from
    1 to admit_min takes 6 steps, from admit_min to 1 takes 10; PID over
    the target pins the integral at -W at once).  PID under the target
    winds the integral up by err a bin: its runs meet after 2 W / err."""
    for scale in (100.0, 0.01):
        args, kw = _ctrl_case(np.random.default_rng(1), 600, 2, 3, 4, policy,
                              "finite", 0.0, "ones")
        args = (torch.full_like(args[0], 3.0 * scale),) + args[1:]
        got, coal = chunked_ctrl(*args, chunk=chunk, **kw)
        assert _same_bits(got, ctrl_mod.admission_ctrl_plain(*args, **kw))
        if chunk == 64 and (policy == "aimd" or scale > 1.0):
            assert bool((coal >= 0).all()) and int(coal.max()) <= 12


def never_coalescing_ctrl(n_ctrl, f, p, g, policy):
    """A window tensor (and its cell) on which no chunk's bracket runs
    ever meet.  AIMD: admit0 = +inf and every window over the target, so
    the upper run stays at +inf (the true trajectory) while the lower
    one falls to admit_min.  PID: every window exactly at the TTFT
    target (TPOT off), so err = 0, the integral runs from -W and W stay
    apart, and admit, which needs the integral, never starts."""
    ttft0 = torch.full((p, g), 1.0)
    tpot0 = torch.zeros(p)
    tt = torch.full((f,), 4.0)
    tp = torch.full((f,), float("inf"))
    kw = dict(increase=0.1, decrease=0.6, admit_min=0.05, pid=None)
    if policy == "aimd":
        win = torch.full((n_ctrl, f, p), 5.0)
        admit0 = torch.full((f, p, g), float("inf"))
    else:
        win = torch.full((n_ctrl, f, p), 3.0)
        admit0 = torch.full((f, p, g), 0.5)
        kw["pid"] = dict(kp=0.4, ki=0.05, kd=0.02, gain=torch.ones(p))
    return (win, ttft0, tpot0, admit0, tt, tp), kw


@pytest.mark.parametrize("policy", ["aimd", "pid"])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunks_that_never_coalesce_are_exact(policy, chunk):
    """Every chunk after the first runs whole from its exact start."""
    args, kw = never_coalescing_ctrl(200, 2, 3, 2, policy)
    got, coal = chunked_ctrl(*args, chunk=chunk, **kw)
    assert _same_bits(got, ctrl_mod.admission_ctrl_plain(*args, **kw))
    assert bool((coal[1:] == -1).all())
    want = float("inf") if policy == "aimd" else 0.5
    assert bool((got == want).all())


def test_nan_met_upstream_reaches_every_later_chunk():
    """A NaN window under PID makes the integral NaN for good; later
    chunks whose own runs meet on a number (every window far over the
    target) still give NaN."""
    args, kw = _ctrl_case(np.random.default_rng(4), 100, 1, 2, 2, "pid",
                          "finite", 0.0, "ones")
    win = torch.full_like(args[0], 300.0)
    win[20] = float("nan")
    args = (win,) + args[1:]
    got, coal = chunked_ctrl(*args, chunk=7, **kw)
    want = ctrl_mod.admission_ctrl_plain(*args, **kw)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got[20:]).all()) and not torch.isnan(got[:20]).any()
    assert bool((coal[3:] == 0).all())     # later chunks met on numbers


@pytest.mark.parametrize("n_ctrl,want", [
    (6_005, 188),       # FleetSim.run() on the paper's world under admission
    (4_096, 128),
    (33, 2),
    (1, 1),
])
def test_ctrl_chunk_pinned(n_ctrl, want):
    assert ctrl_mod.ctrl_chunk(n_ctrl) == want
    assert ctrl_mod.LANES * want >= n_ctrl


# --------------------------------------------------------------------- #
# admission_window: staged tiles of bins, one task a (bin, f, p)
# --------------------------------------------------------------------- #


def tiled_window(wait, work_last, cap, dt, gw, ex, bin_map, seg, n_ctrl):
    """``csrc/admission_window.cu``'s algorithm in numpy: tiles of
    ``window_tile`` bins, the rows after them staged at an odd stride
    (the last bin's row one more step of the recursion), phase A's
    per-(bin, f, p, layer) gateway terms and expert maxima, phase B's
    sums over layers in the reference's order, and the window maxima
    taken on the f32 bit patterns as int32."""
    f32 = np.float32
    n_bins, n_f, n_c = wait.shape
    n_p, n_l = gw.shape[1:]
    n_i = ex.shape[2] // n_l
    tile, stride = window_mod.window_tile(n_f, n_c, n_p, n_l, n_i)
    assert stride >= n_f * n_c and (stride % 2 == 1 or stride % 4 == 0)
    plane = wait.reshape(n_bins, -1)
    win = np.zeros(n_ctrl * n_f * n_p, np.int32)
    for t0 in range(0, n_bins, tile):
        rows = min(tile, n_bins - t0)
        copy_rows = min(rows, n_bins - 1 - t0)
        staged = np.full((tile, stride), np.nan, np.float32)
        staged[:copy_rows, :n_f * n_c] = plane[t0 + 1:t0 + 1 + copy_rows]
        if copy_rows < rows:
            staged[copy_rows, :n_f * n_c] = np.maximum(np.minimum(
                plane[-1] + work_last.reshape(-1), f32(cap)) - f32(dt),
                f32(0.0))
        g_term = np.zeros((n_f * n_p, n_l, rows), np.float32)
        e_max = np.zeros((n_f * n_p, n_l, rows), np.float32)
        for it in range(rows * n_f * n_p * n_l):          # phase A
            b, q = it % rows, it // rows
            ll, fp = q % n_l, q // n_l
            f, p = divmod(fp, n_p)
            row = staged[b, f * n_c:(f + 1) * n_c]
            s = bin_map[t0 + b]
            g_term[fp, ll, b] = row[gw[s, p, ll]]
            e_max[fp, ll, b] = row[ex[s, p, ll * n_i:(ll + 1) * n_i]].max()
        for task in range(rows * n_f * n_p):             # phase B
            b, fp = task % rows, task // rows
            k = int(seg[t0 + b])
            if k >= n_ctrl:
                continue
            g, e = g_term[fp, 0, b], e_max[fp, 0, b]
            for ll in range(1, n_l):
                g = f32(g + g_term[fp, ll, b])
                e = f32(e + e_max[fp, ll, b])
            bits = np.array([g + e], np.float32).view(np.int32)[0]
            key = k * n_f * n_p + fp
            win[key] = max(win[key], bits)
    return win.view(np.float32).reshape(n_ctrl, n_f, n_p)


@pytest.mark.parametrize("t,f,every,last_ctrl,tile_bytes", [
    (157, 1, 10, True, None),
    (157, 4, 10, False, None),
    (60, 2, 7, True, 1500),       # many tiles, a few bins each
    (5, 1, 1, True, 100),         # one bin a tile, every bin a window
])
def test_tiled_window_is_bitwise_the_plain_version(monkeypatch, t, f, every,
                                                   last_ctrl, tile_bytes):
    from test_torch_admission import _window_inputs
    if tile_bytes is not None:
        monkeypatch.setattr(window_mod, "TILE_BYTES", tile_bytes)
    wait, work_last, gw, ex, bin_map, ctrl = _window_inputs(
        3, t, f, every, last_ctrl)
    seg, n_ctrl = window_mod.control_segments(torch.from_numpy(ctrl))
    got = tiled_window(wait, work_last, 0.9, 0.05, gw, ex, bin_map,
                       seg.numpy(), n_ctrl)
    want = window_mod.admission_window_plain(
        torch.from_numpy(wait), torch.from_numpy(work_last), 0.9, 0.05,
        torch.from_numpy(gw), torch.from_numpy(ex),
        torch.from_numpy(bin_map), seg, n_ctrl)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shape,want", [
    ((1, 864, 3, 32, 8), (16, 868)),     # run() on the paper's world
    ((4, 864, 3, 32, 8), (4, 3_460)),    # run_many over 4 targets
    ((11, 864, 3, 32, 8), (1, 9_508)),
    ((1, 4, 2, 2, 2), (1_023, 8)),
    ((1, 5, 2, 2, 2), (1_228, 5)),       # rows not whole 16-byte words
])
def test_window_tile_pinned(shape, want):
    assert window_mod.window_tile(*shape) == want
    n_f, n_c, n_p, n_l, n_i = shape
    tile, stride = want
    assert 4 * (tile * (stride + 2 * n_f * n_p * n_l + 2)
                + n_p * n_l * (1 + n_i)) <= window_mod.SMEM_MAX


def test_window_tile_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        window_mod.window_tile(70, 864, 3, 32, 8)
