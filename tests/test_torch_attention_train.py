"""The port's training attention (B10's plain versions, the dropout hash and
the autograd wrapper) against the JAX package's ``gqa_attention_train`` in
Pallas interpret mode.

Inputs are fp32 and made with numpy from a seed.  Tolerances are the JAX
package's own for this kernel (``tests/test_attention_train.py``): forward
2e-5, gradients 5e-4.  The keep mask is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import attention_train as jat
from jatsr_torch.ops import attention_train as tat


@pytest.mark.parametrize("seed", [0, 12345, -7, -2 ** 31, 2 ** 31 - 1])
@pytest.mark.parametrize("b,h,np_", [(0, 0, 64), (3, 5, 352), (27, 19, 48)])
def test_dropout_keep_mask_bit_equal(seed, b, h, np_):
    want = np.asarray(jat.dropout_keep_mask(jnp.int32(seed), b, h, np_, 0.1))
    got = tat.dropout_keep_mask(seed, b, h, np_, 0.1).numpy()
    np.testing.assert_array_equal(got, want)


def test_keep_fraction_and_lattice():
    """The [B, H, N, N] mask of the plain versions is each (b, h) lattice's
    top-left N x N corner, and keeps ~(1 - rate)."""
    keep = tat._keep_mask(-5, 2, 3, 45, 0.3, "cpu")
    for b in range(2):
        for h in range(3):
            lattice = tat.dropout_keep_mask(-5, b, h, 48, 0.3)
            assert torch.equal(keep[b, h], lattice[:45, :45])
    assert abs(keep.float().mean().item() - 0.7) < 0.02


@pytest.mark.parametrize("n", [64, 80, 345, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (20, 4, 64)])
def test_train_flash_supported_matches_jax(n, hq, hkv, d):
    assert tat.train_flash_supported(n, hq, hkv, d) == \
        jat.train_flash_supported(n, hq, hkv, d)


def _inputs(B, N, hq, hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, w * D), dtype=np.float32)
            for w in (hq, hkv, hkv, hq)]


CASES = pytest.mark.parametrize("N,rate,seed", [
    (64, 0.0, 0), (64, 0.25, 12345), (45, 0.0, 0), (45, 0.25, -99)])


@CASES
def test_forward_matches_jax(N, rate, seed):
    B, hq, hkv, D = 2, 4, 2, 32
    q, k, v, _ = _inputs(B, N, hq, hkv, D, 1)
    want = jat.gqa_attention_train(q, k, v, jnp.array([seed], jnp.int32), hq,
                                   hkv, dropout_rate=rate, interpret=True)
    got, stats = tat.attention_train_fwd(
        *map(torch.from_numpy, (q, k, v)), seed, hq, hkv, rate)
    assert stats is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@CASES
def test_gradients_match_jax(N, rate, seed):
    """The autograd wrapper (the plain backward on the CPU) against
    ``jax.grad`` through the hand-written VJP."""
    B, hq, hkv, D = 2, 4, 2, 16
    q, k, v, r = _inputs(B, N, hq, hkv, D, 2)
    sd = jnp.array([seed], jnp.int32)

    def f(q, k, v):
        return jnp.sum(jat.gqa_attention_train(q, k, v, sd, hq, hkv,
                                               dropout_rate=rate,
                                               interpret=True) * r)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n0 = (tat.attention_train_fwd.launches, tat.attention_train_bwd.launches)
    out = tat.gqa_attention_train(tq, tk, tv, seed, hq, hkv, rate)
    (out * torch.from_numpy(r)).sum().backward()
    assert (tat.attention_train_fwd.launches,
            tat.attention_train_bwd.launches) == n0
    np.testing.assert_allclose(
        float((out.detach() * torch.from_numpy(r)).sum()), float(f(q, k, v)),
        rtol=1e-5)
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{name}")


def test_bf16_plain_keeps_the_rounding_points():
    """In bf16 the plain forward equals the JAX kernel's interpret-mode
    result to one bf16 ulp (both round q', e and o at the same points)."""
    B, N, hq, hkv, D = 2, 40, 4, 2, 32
    q, k, v, _ = _inputs(B, N, hq, hkv, D, 3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jat.gqa_attention_train(
        *bf, jnp.array([3], jnp.int32), hq, hkv, dropout_rate=0.1,
        interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tat.attention_train_fwd_plain(tq, tk, tv, 3, hq, hkv, 0.1).float()
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2.0 ** -8 * np.abs(want).max())
