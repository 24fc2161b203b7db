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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", [
    (8, 2, 4096, 1376),    # decode step: the skinny path (K split)
    (8, 2, 1376, 4096),
    (8, 40, 1376, 4096),   # prefill: the tiled path
    (3, 130, 100, 36),     # ragged: tiled
    (3, 3, 100, 36),       # ragged skinny (f32) / tiled (bf16: N % 8 != 0)
    (5, 1, 7, 8),          # fewer K rows than warps
])
def test_gmm_kernel_matches_plain(cuda_device, e, c, k, n, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(e, c, k, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(e, k, n, generator=gen, device=cuda_device).to(dtype)
    before = moe_gmm.launches
    got = moe_gmm.gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    want = moe_gmm.gmm_plain(x, w)
    # Sums over K ~ sqrt(K) in size: compare relative to the largest entry.
    scale = float(want.float().abs().max())
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale, **TOL[dtype])


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
