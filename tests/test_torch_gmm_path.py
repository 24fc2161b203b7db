"""The gmm wrapper's choice of kernel path and tiling, on the CPU.

``moe_gmm.gmm_path`` picks the tensor-core path (``"wgmma"``, TMA-fed) or
the CUDA-core FMA tiles from shapes, type and alignment alone, before any
launch; ``gmm_depth`` sets how many stages of a wgmma call's ring are in
flight.  Neither touches a card, so they are pinned here.
"""
import pytest
import torch

from repro_torch.kernels import moe_gmm, ops

ALIGNED = (1 << 20, 2 << 20, 3 << 20)      # 16-byte aligned data pointers


@pytest.mark.parametrize("e,c,k,n", [
    (8, 2, 4096, 1376), (8, 40, 4096, 1376),    # serve: gate/up projections
    (8, 2, 1376, 4096), (8, 40, 1376, 4096),    # serve: down projection
    (8, 2560, 4096, 1376),                      # prefill at batch 4 x 2048
])
def test_serve_shapes_take_the_tensor_cores(e, c, k, n):
    assert moe_gmm.gmm_path(k, n, torch.bfloat16, ALIGNED) == "wgmma"


@pytest.mark.parametrize("e,c,k,n", [(8, 2, 4096, 1376), (8, 40, 1376, 4096),
                                     (8, 2560, 4096, 1376)])
def test_float32_takes_fma(e, c, k, n):
    assert moe_gmm.gmm_path(k, n, torch.float32, ALIGNED) == "fma"


@pytest.mark.parametrize("k,n", [(4096, 1380), (4100, 1376), (100, 36),
                                 (7, 8), (0, 8)])
def test_rows_tma_cannot_take_go_to_fma(k, n):
    """K or N not a multiple of 8 (row strides not a multiple of 16 bytes)."""
    assert moe_gmm.gmm_path(k, n, torch.bfloat16, ALIGNED) == "fma"


@pytest.mark.parametrize("which", range(3))
@pytest.mark.parametrize("offset", [2, 8])
def test_misaligned_pointer_takes_fma(which, offset):
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    assert moe_gmm.gmm_path(4096, 1376, torch.bfloat16, ptrs) == "fma"


@pytest.mark.parametrize("e,c,k,n,want", [
    (8, 2, 4096, 1376, 4),      # 88 blocks: ~6 MB in flight at depth 4
    (8, 2, 1376, 4096, 2),      # 256 blocks: depth 2 suffices
    (8, 40, 4096, 1376, 4),
    (8, 40, 1376, 4096, 2),
    (8, 2560, 4096, 1376, 0),   # wide: the whole ring
    (8, 65, 1376, 4096, 0),
])
def test_serve_shapes_tiling(e, c, k, n, want):
    assert moe_gmm.gmm_depth(e, c, n) == want


@pytest.mark.parametrize("e,c,n", [(1, 2, 1376), (1, 2, 4096), (2, 8, 512),
                                   (1, 1, 8), (8, 64, 1376)])
def test_narrow_depth_keeps_the_bytes_in_flight(e, c, n):
    """At least 2 stages, and one stage fewer would fall short of
    IN_FLIGHT bytes requested across the card (unless at 2 already)."""
    depth = moe_gmm.gmm_depth(e, c, n)
    blocks = e * -(-n // moe_gmm.BLOCK_N)
    stage = (moe_gmm.BLOCK_N + -(-c // 8) * 8) * moe_gmm.K_STEP * 2
    assert depth >= 2
    assert depth == 2 or (depth - 1) * blocks * stage < moe_gmm.IN_FLIGHT
    assert depth * blocks * stage >= moe_gmm.IN_FLIGHT or depth == 2


def test_path_and_depth_are_cached_per_shape():
    """The shape work runs once per shape; a repeat call is a cache hit."""
    moe_gmm.gmm_path(4096, 1376, torch.bfloat16, ALIGNED)
    moe_gmm.gmm_depth(8, 2, 1376)
    rows, depth = (moe_gmm._tma_rows.cache_info().hits,
                   moe_gmm.gmm_depth.cache_info().hits)
    moe_gmm.gmm_path(4096, 1376, torch.bfloat16, ALIGNED)
    moe_gmm.gmm_depth(8, 2, 1376)
    assert moe_gmm._tma_rows.cache_info().hits == rows + 1
    assert moe_gmm.gmm_depth.cache_info().hits == depth + 1


def test_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 16, dtype=torch.bfloat16)
    w = torch.randn(2, 16, 8, dtype=torch.bfloat16)
    torch.testing.assert_close(moe_gmm.gmm(x, w), moe_gmm.gmm_plain(x, w))
    assert moe_gmm.launches == 0
    assert moe_gmm.path_launches == {"wgmma": 0, "fma": 0}
