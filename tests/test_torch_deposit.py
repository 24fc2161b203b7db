"""The port's deposit (plain version) against the reference's.

``repro_torch.kernels.deposit`` runs its plain version on the CPU; it
must equal ``repro.kernels.ref.deposit_ref`` (the f64 scatter-add the
reference's fused fleet path uses off TPU) bit for bit under x64, on the
tables the fleet produces and on adversarial ones.  Against the Pallas
kernel (interpret mode, f32: its one-hot matmul sums in another order)
the tolerance is the reference's own, rtol 1e-6.  The CUDA kernel is
held to the plain version on a card (``test_torch_kernels_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import deposit as pallas_deposit
from repro.kernels.ref import deposit_ref
from repro_torch.kernels import deposit, ops


def _table(case, n_rows, n_cols, n, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n)
    cols = rng.integers(0, n_cols, n)
    vals = rng.random(n) * 0.05
    if case == "grouped":
        # Row-grouped (stable) with the fleet's zero-valued padded tail.
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        pad = 8192 - n % 8192
        rows = np.concatenate([rows, np.zeros(pad, np.int64)])
        cols = np.concatenate([cols, np.zeros(pad, np.int64)])
        vals = np.concatenate([vals, np.zeros(pad)])
    elif case == "duplicates":
        rows = rng.integers(0, 2, n)
        cols = rng.integers(0, 3, n)
    return rows, cols, vals


@pytest.mark.parametrize("case,n_rows,n_cols,n", [
    ("shuffled", 17, 300, 1000),
    ("shuffled", 144, 2568, 20000),
    ("grouped", 40, 900, 5000),
    ("empty", 8, 128, 0),
    ("duplicates", 4, 16, 3000),
])
def test_plain_deposit_is_bitwise_deposit_ref_f64(case, n_rows, n_cols, n):
    rows, cols, vals = _table(case, n_rows, n_cols, n)
    got = deposit.deposit(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals), n_rows, n_cols)
    with jax.enable_x64(True):
        want = np.asarray(deposit_ref(jnp.asarray(rows), jnp.asarray(cols),
                                      jnp.asarray(vals), n_rows, n_cols))
    assert got.shape == (n_rows, n_cols) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_deposit_sums_each_cell_in_table_order():
    """One cell, values whose float64 sum depends on the order."""
    vals = np.array([1e16, 1.0, -1e16, 1.0, 3.0])
    got = deposit.deposit_plain(torch.zeros(5, dtype=torch.int64),
                                torch.zeros(5, dtype=torch.int64),
                                torch.from_numpy(vals), 1, 1)
    acc = 0.0
    for v in vals:
        acc += v
    assert got.item() == acc


@pytest.mark.parametrize("n_rows,n_cols,n", [(17, 300, 1000), (8, 128, 7)])
def test_plain_deposit_matches_pallas_interpret_f32(n_rows, n_cols, n):
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n_rows, n).astype(np.int32)
    cols = rng.integers(0, n_cols, n).astype(np.int32)
    vals = rng.random(n).astype(np.float32)
    pallas = pallas_deposit(jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(vals), n_rows, n_cols, block_r=64,
                            block_c=256, block_t=128, interpret=True)
    got = deposit.deposit(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals), n_rows, n_cols)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-6,
                               atol=1e-6)


def test_stable_row_grouping_leaves_every_cell_bitwise_unchanged():
    """The kernel takes the table grouped by row (``row_ptr``); a stable
    grouping keeps each cell's values in table order, so the plane of
    the grouped table is the plane of the table as it came."""
    rng = np.random.default_rng(11)
    n_rows, n_cols, n = 6, 5, 4000
    rows = rng.integers(0, n_rows, n)
    cols = rng.integers(0, n_cols, n)
    vals = rng.random(n) * np.exp(rng.normal(0.0, 8.0, n))
    order = np.argsort(rows, kind="stable")
    row_ptr = np.searchsorted(rows[order], np.arange(n_rows + 1))
    assert row_ptr[0] == 0 and row_ptr[-1] == n
    got = deposit.deposit(torch.from_numpy(rows[order]),
                          torch.from_numpy(cols[order]),
                          torch.from_numpy(vals[order]), n_rows, n_cols,
                          row_ptr=torch.from_numpy(row_ptr))
    want = deposit.deposit_plain(torch.from_numpy(rows),
                                 torch.from_numpy(cols),
                                 torch.from_numpy(vals), n_rows, n_cols)
    assert torch.equal(got, want)


def test_plain_deposit_matches_a_sequential_loop_f32():
    """In float32 too, each cell is the in-order sum of its values."""
    rows, cols, vals = _table("duplicates", 4, 16, 2000, seed=3)
    vals = vals.astype(np.float32)
    want = np.zeros((4, 16), np.float32)
    for r, c, v in zip(rows, cols, vals):
        want[r, c] = np.float32(want[r, c] + v)
    got = deposit.deposit(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals), 4, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.launch_counts()["deposit"] == 0          # plain, not launched
