"""Head dims without a kernel instance of their own, and B15/B16 past 1024
keys, against the JAX kernels in interpret mode.

The attention kernels are built for head dims 16, 32, 64 and 128.  Any
other head dim up to 128 runs on the next instance up, and a head dim past
128 on the wide kernels (``csrc/attention_wide.cu``) at the next multiple
of 128: the wrappers widen each head with zero columns (``pad_heads``: an
even head's halves at ``[0, d/2)`` and ``[dp/2, dp/2 + d/2)``, and RoPE's
tables alike, so that the half rotation pairs the true columns), launch
the kernel at the true head dim's scale, and slice the output back
(``unpad_heads``).  Here that transform runs through the plain versions at
the padded width (the card runs the kernels on it) and is held against the
plain version at the true width and against the JAX kernel in interpret
mode, at D = 8, 24, 48, 128, 192 (padded to 256) and 256: B2 with and
without the key mask, B11, B15, B16, and B10's forward and gradients.
Inputs are fp32 made with numpy from a seed.

Tolerances are those of the existing attention parity tests: 2e-5 for the
forwards (``tests/test_torch_attention.py``,
``tests/test_torch_attention_split.py``), 5e-4 for B10's gradients
(``tests/test_torch_attention_train.py``).  A zero column adds exactly 0
to every score, so the padded and the true-width plain versions differ
only in the order of the fp32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dit import rope_cos_sin
from jatsr_tpu.ops import attention as jattn
from jatsr_tpu.ops import attention_train as jat
from jatsr_torch.ops import attention_train as tat
from jatsr_torch.ops.attention import (flash_qkv_plain, flash_split_plain,
                                       gqa_attention, gqa_attention_grouped,
                                       gqa_attention_plain, pad_heads,
                                       padded_head_dim, unpad_heads)

DS = [8, 24, 48, 128, 192, 256]
B, N, HQ, HKV = 2, 45, 4, 2


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _padded(fn, D, *xs):
    """``fn`` on ``xs`` ([.., H * D] each) widened to the padded head dim,
    its output sliced back to D."""
    Dp = padded_head_dim(D)
    return unpad_heads(fn(*(pad_heads(x, D, Dp) for x in xs)), D, Dp)


@pytest.mark.parametrize("D", [8, 24, 48, 128, 130])
def test_pad_heads_layout(D):
    """Each head's halves land at [0, D/2) and [Dp/2, Dp/2 + D/2) of its
    Dp columns, zeros elsewhere; unpad_heads inverts it; past 128 the
    padded head dim is the next multiple of 128 (the wide kernels)."""
    Dp = padded_head_dim(D)
    assert Dp == (next(p for p in (16, 32, 64, 128) if D <= p) if D <= 128
                  else -(-D // 128) * 128)
    x = torch.arange(1, 3 * D + 1, dtype=torch.float32).reshape(1, 3 * D)
    y = pad_heads(x, D, Dp).reshape(3, 2, Dp // 2)
    for h in range(3):
        for half in range(2):
            first = h * D + half * (D // 2) + 1
            assert y[h, half, :D // 2].tolist() == list(
                range(first, first + D // 2))
            assert (y[h, half, D // 2:] == 0).all()
    assert torch.equal(unpad_heads(pad_heads(x, D, Dp), D, Dp), x)


@pytest.mark.parametrize("n_valid", [0, N - 7])
@pytest.mark.parametrize("D", DS)
def test_flash_qkv_padded_matches_true_width_and_jax(D, n_valid):
    """B2 (RoPE inside, base-2 scores, keys masked at n_valid)."""
    rng = np.random.default_rng(D + n_valid)
    qkv = rng.standard_normal((B, N, (HQ + 2 * HKV) * D), dtype=np.float32)
    cos, sin = (np.array(a) for a in rope_cos_sin(N, D))
    want = jattn.gqa_attention_flash_qkv(jnp.asarray(qkv), jnp.asarray(cos),
                                         jnp.asarray(sin), HQ, HKV,
                                         interpret=True, n_valid=n_valid)
    t = torch.from_numpy
    true = flash_qkv_plain(t(qkv), t(cos), t(sin), HQ, HKV, n_valid)
    got = _padded(lambda a, c, s: flash_qkv_plain(a, c, s, HQ, HKV, n_valid,
                                                  scale_dim=D),
                  D, t(qkv), t(cos), t(sin))
    assert got.shape == (B, N, HQ * D)
    _close(got, true)
    _close(got, want)


def _split_inputs(D, seed, n=N, hq=HQ, hkv=HKV):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, hq, D), dtype=np.float32),
            rng.standard_normal((B, n, hkv, D), dtype=np.float32),
            rng.standard_normal((B, n, hkv, D), dtype=np.float32))


def _flat(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


@pytest.mark.parametrize("D", DS)
def test_flash_split_padded_matches_true_width_and_jax(D):
    """B11 (N = 45: three zero keys pad N to 48, in the row max)."""
    q, k, v = (_flat(x) for x in _split_inputs(D, 100 + D))
    want = jattn.gqa_attention_flash(q, k, v, HQ, HKV, interpret=True)
    t = torch.from_numpy
    true = flash_split_plain(t(q), t(k), t(v), HQ, HKV)
    got = _padded(lambda a, b, c: flash_split_plain(a, b, c, HQ, HKV,
                                                    scale_dim=D),
                  D, t(q), t(k), t(v))
    _close(got, true)
    _close(got, want)


@pytest.mark.parametrize("kind", ["pallas", "pallas2"])
@pytest.mark.parametrize("D", DS)
def test_natural_padded_matches_true_width_and_jax(D, kind):
    """B15 (``pallas``) and B16 (``pallas2``): one plain version."""
    q, k, v = _split_inputs(D, 200 + D)
    fn = jattn.gqa_attention if kind == "pallas" else \
        jattn.gqa_attention_grouped
    want = fn(q, k, v, interpret=True)
    t = torch.from_numpy
    true = gqa_attention_plain(t(q), t(k), t(v))
    got = _padded(lambda a, b, c: _flat(gqa_attention_plain(
        *(x.reshape(B, N, -1, padded_head_dim(D)) for x in (a, b, c)),
        scale_dim=D)), D, *(_flat(t(x)) for x in (q, k, v)))
    _close(got, _flat(true))
    _close(got, _flat(want))


def _train_inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, w * D), dtype=np.float32)
            for w in (HQ, HKV, HKV, HQ)]


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.25, 12345)])
@pytest.mark.parametrize("D", DS)
def test_train_padded_forward_and_gradients_match_true_width_and_jax(
        D, rate, seed):
    """B10: the forward and, through the padded backward from the padded
    forward's o, dq, dk and dv (the loss sum(o * r))."""
    q, k, v, r = _train_inputs(D, 300 + D)
    sd = jnp.array([seed], jnp.int32)

    def f(q, k, v):
        return jnp.sum(jat.gqa_attention_train(q, k, v, sd, HQ, HKV,
                                               dropout_rate=rate,
                                               interpret=True) * r)

    want_o = jat.gqa_attention_train(q, k, v, sd, HQ, HKV, dropout_rate=rate,
                                     interpret=True)
    want_g = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    t = torch.from_numpy
    tq, tk, tv, tr = map(t, (q, k, v, r))
    true_o = tat.attention_train_fwd_plain(tq, tk, tv, seed, HQ, HKV, rate)
    Dp = padded_head_dim(D)
    pq, pk, pv, pr = (pad_heads(x, D, Dp) for x in (tq, tk, tv, tr))
    po = tat.attention_train_fwd_plain(pq, pk, pv, seed, HQ, HKV, rate,
                                       scale_dim=D)
    _close(unpad_heads(po, D, Dp), true_o)
    _close(unpad_heads(po, D, Dp), want_o)
    grads = tat.attention_train_bwd_plain(pq, pk, pv, po, pr, seed, HQ, HKV,
                                          rate, scale_dim=D)
    true_g = tat.attention_train_bwd_plain(tq, tk, tv, true_o, tr, seed, HQ,
                                           HKV, rate)
    for g, tg, w, name in zip(grads, true_g, want_g, "qkv"):
        g = unpad_heads(g, D, Dp)
        _close(g, tg, 5e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("kind", ["pallas", "pallas2"])
def test_natural_plain_matches_jax_past_1024_keys(kind):
    """B15 and B16 at N = 1100 (4/2 heads, head dim 16), where the port's
    kernels take their streaming mode: the port's plain version (the CPU
    path of ``gqa_attention`` and ``gqa_attention_grouped``) against the JAX
    kernel in interpret mode."""
    q, k, v = _split_inputs(16, 400, n=1100)
    fn = jattn.gqa_attention if kind == "pallas" else \
        jattn.gqa_attention_grouped
    port = gqa_attention if kind == "pallas" else gqa_attention_grouped
    want = fn(q, k, v, interpret=True)
    got = port(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (B, 1100, HQ, 16)
    _close(got, want)
