"""The port's attention on split, RoPE'd q/k/v against the JAX kernels: the
split flash kernel (``gqa_attention_flash``), the per-q-head kernel
(``gqa_attention``) and the per-kv-head kernel (``gqa_attention_grouped``).

The JAX side runs its kernels in interpret mode, as the JAX package's own
tests do on the CPU; the port's wrappers take their plain PyTorch versions
for CPU tensors.  Inputs are made with numpy from a seed and handed to both.

Tolerances.  fp32 at atol = rtol = 2e-5, the JAX package's own bound for
these kernels (``tests/test_pallas_attention.py``): only summation order
and the last bit of exp / exp2 differ.  bf16: both sides round at the same
points, so an output differs only where a bf16 softmax weight flips by one
ulp between the frameworks; beyond one bf16 ulp on at most 0.5 % of the
outputs (measured: at most 0.013 %), and within 2e-2 everywhere, the bound
of the other attention parity tests.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import attention as jattn
from jatsr_torch.ops.attention import (flash_split_plain, gqa_attention,
                                       gqa_attention_flash,
                                       gqa_attention_grouped,
                                       gqa_attention_plain)

B, HQ, HKV = 2, 8, 2


def _inputs(seed, N, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, HQ, D), dtype=np.float32),
            rng.standard_normal((B, N, HKV, D), dtype=np.float32),
            rng.standard_normal((B, N, HKV, D), dtype=np.float32))


def _flat(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def _jax(kind, q, k, v):
    """The JAX kernel of ``kind`` in interpret mode, as [B, N, Hq, D]."""
    if kind == "flash":
        out = jattn.gqa_attention_flash(_flat(q), _flat(k), _flat(v), HQ, HKV,
                                        interpret=True)
        return out.reshape(q.shape)
    fn = jattn.gqa_attention if kind == "pallas" else \
        jattn.gqa_attention_grouped
    return fn(q, k, v, interpret=True)


def _port(kind, q, k, v):
    if kind == "flash":
        return gqa_attention_flash(_flat(q), _flat(k), _flat(v), HQ,
                                   HKV).reshape(q.shape)
    fn = gqa_attention if kind == "pallas" else gqa_attention_grouped
    return fn(q, k, v)


def _bf16_ulp(a, b):
    """The bf16 spacing at max(|a|, |b|)."""
    x = np.maximum(np.abs(a), np.abs(b))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def _assert_bf16_close(got, want):
    diff = np.abs(got - want)
    assert (diff > _bf16_ulp(got, want)).mean() <= 0.005
    assert diff.max() <= 2e-2, diff.max()


@pytest.mark.parametrize("kind", ["flash", "pallas", "pallas2"])
@pytest.mark.parametrize("N,D", [(90, 32), (90, 64), (345, 32), (345, 64),
                                 (864, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_attention_matches_jax(kind, N, D, dtype):
    """N = 90 pads to 96 (flash) and 128 (pallas, pallas2); N = 345, the
    serving patch count, to 352 and 384; N = 864 at D = 16, the JAX kernel
    tests' smallest head dim, past the 768 keys the port's kernels held
    before (eight 128-key chunks)."""
    q, k, v = _inputs(N + D, N, D)
    want = np.asarray(_jax(kind, *(jnp.asarray(x, dtype) for x in (q, k, v))),
                      np.float32)
    got = _port(kind, *(torch.from_numpy(x).to(getattr(torch, dtype))
                        for x in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        _assert_bf16_close(got, want)


def _negative_scores(seed, N, D):
    """q >= 0 and k <= 0 entrywise: every real score is negative (the real
    row maxima lie below -1 in the base-2 domain), so the zero keys that pad
    N to a multiple of 8 set each row's max."""
    rng = np.random.default_rng(seed)
    q = np.abs(rng.standard_normal((B, N, HQ * D), dtype=np.float32))
    k = -np.abs(rng.standard_normal((B, N, HKV * D), dtype=np.float32))
    v = rng.standard_normal((B, N, HKV * D), dtype=np.float32)
    return q, k, v


def _masked_softmax(q, k, v, D):
    """The same rounding points with the padded keys masked instead (B2's
    softmax): bf16(e) against the max of the real scores."""
    N = q.shape[1]

    def heads(x, h):  # [B, N, h*D] -> [B, HQ, N, D]
        x = x.reshape(B, N, h, D).transpose(1, 2)
        return x.repeat_interleave(HQ // h, dim=1)

    scale2 = torch.tensor((1.0 / math.sqrt(D)) * math.log2(math.e),
                          dtype=q.dtype)
    s = (heads(q, HQ) * scale2).float() @ heads(k, HKV).float() \
        .transpose(-1, -2)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = (e.to(q.dtype).float() @ heads(v, HKV).float()) / e.sum(
        dim=-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2).reshape(B, N, HQ * D), s


def test_flash_padding_keys_set_the_row_max():
    """The split flash kernel does not mask the keys that pad N = 90 to 96:
    they score 0 and are each row's max.  The port matches JAX there, and
    differs from a masked softmax (at the bf16 level, on about half of the
    outputs: bf16(e) rounds against another max)."""
    D = 32
    q, k, v = _negative_scores(7, 90, D)
    want = np.asarray(jattn.gqa_attention_flash(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), HQ, HKV,
        interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = gqa_attention_flash(tq, tk, tv, HQ, HKV).float().numpy()
    _assert_bf16_close(got, want)
    masked, scores = _masked_softmax(tq, tk, tv, D)
    assert scores.amax().item() < -1.0
    assert (masked.float().numpy() != want).mean() > 0.1


def test_split_attention_shape_checks():
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 16, 32))
    n0 = (gqa_attention_flash.launches, gqa_attention.launches,
          gqa_attention_grouped.launches)
    with pytest.raises(ValueError):
        gqa_attention_flash(_flat(q), _flat(k)[..., :-1], _flat(v), HQ, HKV)
    with pytest.raises(ValueError):
        gqa_attention_flash(_flat(q), _flat(k), _flat(v), HQ, 3)
    with pytest.raises(ValueError):
        gqa_attention(q, k[:, :-1], v[:, :-1])
    with pytest.raises(ValueError):
        gqa_attention_grouped(q[..., :-1, :], k, v)
    with pytest.raises(ValueError):
        gqa_attention(_flat(q), _flat(k), _flat(v))
    assert (gqa_attention_flash.launches, gqa_attention.launches,
            gqa_attention_grouped.launches) == n0


def test_plain_versions_are_the_cpu_path():
    """A CPU tensor takes the plain version and counts no launch; the two
    pallas kernels compute one function."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(4, 40, 64))
    n0 = (gqa_attention.launches, gqa_attention_grouped.launches)
    a, b = gqa_attention(q, k, v), gqa_attention_grouped(q, k, v)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(a, gqa_attention_plain(q, k, v), atol=0,
                               rtol=0)
    torch.testing.assert_close(
        gqa_attention_flash(_flat(q), _flat(k), _flat(v), HQ, HKV),
        flash_split_plain(_flat(q), _flat(k), _flat(v), HQ, HKV), atol=0,
        rtol=0)
    assert (gqa_attention.launches, gqa_attention_grouped.launches) == n0
