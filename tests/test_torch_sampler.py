"""The activation model's device forms in the port against the reference's
``_jax`` forms, on the CPU.

Both get the same float32 numpy weights.  ``esp``, ``activation_probs``
and ``esp_prefix_table`` take the same steps in the same order; the
tolerance is rtol 1e-6 because the mean that scales the weights is a
float32 reduction whose order XLA and PyTorch choose (in practice the
results agree to the last bit or one).  ``sample_topk`` compares draws
exactly: fed the uniforms ``jax.random.uniform(key, (I, n))`` drew, the
port takes the same items.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro.core import activation as jact

RTOL = 1e-6


def _weights(seed: int, n: int, skew: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(n) ** (1 + skew) + 1e-3).astype(np.float32)


CASES = [(0, 8, 0.0, 2), (1, 8, 2.0, 3), (2, 64, 1.0, 6), (3, 16, 4.0, 1),
         (4, 5, 0.5, 5)]


@pytest.mark.parametrize("seed,n,skew,k", CASES[:4])
def test_esp_forms_match_reference(seed, n, skew, k):
    w = _weights(seed, n, skew)
    for port, ref in ((pc.esp_torch, jact.esp_jax),
                      (pc.esp_prefix_table_torch, jact.esp_prefix_table_jax),
                      (pc.activation_probs_torch, jact.activation_probs_jax)):
        got = port(torch.from_numpy(w), k).numpy()
        want = np.asarray(ref(jnp.asarray(w), k))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_activation_probs_at_k_equal_i_cancels_in_both():
    """K = I: every P_i is 1, but the subtractive leave-one-out recurrence
    of the device form cancels catastrophically (the host form special-
    cases it).  The reference's own result is 6e-5 off 1 here, so the two
    packages agree to that, not to rtol 1e-6; the ESPs themselves do."""
    w = _weights(4, 5, 0.5)
    got = pc.activation_probs_torch(torch.from_numpy(w), 5).numpy()
    want = np.asarray(jact.activation_probs_jax(jnp.asarray(w), 5))
    np.testing.assert_allclose(want, np.ones(5), atol=1e-3)
    np.testing.assert_allclose(got, np.ones(5), atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    for port, ref in ((pc.esp_torch, jact.esp_jax),
                      (pc.esp_prefix_table_torch, jact.esp_prefix_table_jax)):
        np.testing.assert_allclose(port(torch.from_numpy(w), 5).numpy(),
                                   np.asarray(ref(jnp.asarray(w), 5)),
                                   rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("seed,n,skew,k", CASES[:3])
def test_device_forms_agree_with_the_exact_host_forms(seed, n, skew, k):
    """The float32 device forms near the float64 host DPs."""
    w = _weights(seed, n, skew)
    t = torch.from_numpy(w)
    np.testing.assert_allclose(pc.esp_torch(t, k).numpy(), pc.esp(w, k),
                               rtol=1e-4)
    np.testing.assert_allclose(pc.activation_probs_torch(t, k).numpy(),
                               pc.activation_probs(w, k), rtol=1e-3,
                               atol=1e-5)


def test_forms_take_leading_batch_dims():
    w = np.stack([_weights(s, 8, 1.0) for s in range(3)])
    t = torch.from_numpy(w)
    for fn in (pc.esp_torch, pc.esp_prefix_table_torch,
               pc.activation_probs_torch):
        batched = fn(t, 3)
        for row in range(3):
            assert torch.equal(batched[row], fn(t[row], 3))


@pytest.mark.parametrize("seed,n,skew,k", CASES)
@pytest.mark.parametrize("n_draws", [1, 997])
def test_sample_topk_takes_the_references_draws(seed, n, skew, k, n_draws):
    w = _weights(seed, n, skew)
    key = jax.random.PRNGKey(seed + 11)
    want = np.asarray(jact.sample_topk_jax(jnp.asarray(w), k, key, n_draws))
    u = np.array(jax.random.uniform(key, (n, n_draws), dtype=jnp.float32))
    got = pc.sample_topk_torch(torch.from_numpy(w), k, torch.from_numpy(u))
    assert tuple(got.shape) == (n_draws, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_topk_from_a_generator():
    """K distinct experts a draw, marginals at Eq. 14, the generator's
    stream equal to explicit uniforms of the same shape."""
    w = _weights(5, 8, 1.0)
    t = torch.from_numpy(w)
    draws = pc.sample_topk_torch(t, 3, torch.Generator().manual_seed(0),
                                 20000)
    assert (np.diff(np.sort(draws.numpy(), axis=1), axis=1) != 0).all()
    freq = np.bincount(draws.numpy().ravel(), minlength=8) / 20000
    np.testing.assert_allclose(freq, pc.activation_probs(w, 3), atol=0.02)
    u = torch.rand((8, 20000), generator=torch.Generator().manual_seed(0))
    assert torch.equal(pc.sample_topk_torch(t, 3, u), draws)
    with pytest.raises(ValueError, match="n_draws"):
        pc.sample_topk_torch(t, 3, torch.Generator())
    with pytest.raises(ValueError, match="K <= I"):
        pc.sample_topk_torch(t, 9, u)
    with pytest.raises(ValueError, match="uniforms"):
        pc.sample_topk_torch(t, 3, u[:4])


def test_engine_sampler_is_sample_topk_over_layers():
    """``engine.sample_draws_torch`` is ``sample_topk_torch`` on the (L, I)
    weights: per layer, the draws of that layer's uniforms (which the test
    above holds to the reference)."""
    act = pc.ActivationModel.zipf(4, 8, 2, seed=1)
    draws = pc.engine.sample_draws_torch(act, 500,
                                         torch.Generator().manual_seed(2),
                                         torch.device("cpu"))
    assert tuple(draws.shape) == (4, 500, 2)
    u = torch.rand((4, 8, 500), generator=torch.Generator().manual_seed(2))
    w = torch.from_numpy(act.weights.astype(np.float32))
    for layer in range(4):
        assert torch.equal(draws[layer],
                           pc.sample_topk_torch(w[layer], 2, u[layer]))
