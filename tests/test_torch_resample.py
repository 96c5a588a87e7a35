"""The port's windowed-sinc resampler against the JAX package.

Both build the filter bank in float64 numpy and cast it to fp32 the same
way (the banks are bit-equal); each runs one fp32 strided convolution, so
the outputs differ only by the sum order of the K = 2 * width + orig taps:
within 2e-6 absolute on signals of amplitude ~1 (measured up to 3.0e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops.resample import _sinc_kernel as jax_sinc_kernel
from jatsr_tpu.ops.resample import resample as jax_resample
from jatsr_tpu.ops.resample import simulate_lr as jax_simulate_lr
from jatsr_torch.ops.resample import _sinc_kernel, resample, simulate_lr

RATES = [(48000, 16000), (16000, 44100), (44100, 48000), (48000, 44100)]


def _signal(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("orig,new", RATES)
def test_sinc_bank_equals_jax(orig, new):
    w, width = _sinc_kernel(orig // np.gcd(orig, new), new // np.gcd(orig, new))
    jw, jwidth = jax_sinc_kernel(orig // np.gcd(orig, new),
                                 new // np.gcd(orig, new))
    assert width == jwidth
    np.testing.assert_array_equal(w[:, 0, :], jw[:, 0, :].T)


@pytest.mark.parametrize("orig,new", RATES)
@pytest.mark.parametrize("shape", [(2, 4801), (2, 4801, 3)],
                         ids=["2d", "3d"])
def test_resample_matches_jax(orig, new, shape):
    x = _signal(shape)
    want = np.asarray(jax_resample(jnp.asarray(x), orig, new))
    got = resample(torch.from_numpy(x), orig, new).numpy()
    T = shape[1]
    assert got.shape == want.shape
    assert got.shape[1] == -(-new * T // orig)  # ceil(new * T / orig)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 4801), (1, 4800, 2)],
                         ids=["2d", "3d"])
def test_simulate_lr_matches_jax(shape):
    x = _signal(shape, seed=1)
    want = np.asarray(jax_simulate_lr(jnp.asarray(x)))
    got = simulate_lr(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def test_resample_same_rate_is_the_identity():
    x = torch.randn(1, 100)
    assert resample(x, 16000, 16000) is x
