"""The port's loss stack against the JAX package's ``losses`` in fp32.

Inputs are made with numpy from a seed, ``[B, T, C]`` time-major.  Both
sides take an fp32 real FFT over time with different libraries, whose sums
run in another order: the spectral terms agree to rtol 1e-5, the
time-domain ones to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.losses import perceptual as jl
from jatsr_tpu.configs import LossConfig as JaxLossConfig
from jatsr_torch import losses as tl
from jatsr_torch.configs import LossConfig
from jatsr_torch.sampling.flow import linspace_f32


def _data(T=173, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, T, 24), dtype=np.float32)
            for _ in range(3)]


def _pair(fn_j, fn_t, arrays, rtol, **kw):
    want = float(fn_j(*map(jnp.asarray, arrays), **kw))
    got = float(fn_t(*map(torch.from_numpy, arrays), **kw))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("T", [173, 256])
def test_spectral_terms(T):
    p, t, lr = _data(T)
    _pair(jl.frequency_domain_loss, tl.frequency_domain_loss, (p, t), 1e-5)
    _pair(jl.frequency_domain_loss, tl.frequency_domain_loss, (p, t), 1e-5,
          low_freq_phase_ratio=0.5)
    _pair(jl.buggy_frequency_domain_loss, tl.buggy_frequency_domain_loss,
          (p, t), 1e-5, high_freq_weight=3.0)
    _pair(jl.consistency_loss, tl.consistency_loss, (p, lr), 1e-5)
    _pair(jl.consistency_loss, tl.consistency_loss, (p, lr), 1e-5,
          strict_cutoff=0.3, soft_cutoff=0.3)


@pytest.mark.parametrize("T", [173, 256])
def test_time_domain_terms(T):
    p, t, _ = _data(T, 1)
    _pair(jl.multi_scale_loss, tl.multi_scale_loss, (p, t), 1e-6)
    _pair(jl.multi_scale_loss, tl.multi_scale_loss, (p, t), 1e-6,
          scales=(1, 3, 8))
    _pair(jl.charbonnier_loss, tl.charbonnier_loss, (p, t), 1e-6)


@pytest.mark.parametrize("kw", [
    dict(reconstruction="mse"),
    dict(reconstruction="charbonnier", use_latent_perceptual=True),
    dict(reconstruction="mse", use_latent_perceptual=True),
    dict(reconstruction="mse", use_latent_perceptual=True,
         freq_loss_variant="buggy_v3mod1", consistency_weight=0.0)])
def test_total_training_loss(kw):
    p, t, lr = _data(173, 2)
    want_l, want_m = jl.total_training_loss(*map(jnp.asarray, (p, t, lr)),
                                            JaxLossConfig(**kw))
    got_l, got_m = tl.total_training_loss(*map(torch.from_numpy, (p, t, lr)),
                                          LossConfig(**kw))
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)


@pytest.mark.parametrize("start,stop,n", [(1.0, 0.0, 5), (1.0, 0.0, 43),
                                          (1.0, 3.0, 129), (0.0, 0.05, 28),
                                          (0.0, 1.0, 51)])
def test_ramps_equal_jitted_jnp_linspace(start, stop, n):
    """The consistency ramp, the drop-path ramp and the sampler schedule are
    bit-equal to ``jnp.linspace`` under ``jit`` (the buggy control's 1 -> 2
    ramp may differ by an ulp: XLA's own eager and jitted results differ
    there)."""
    np.testing.assert_array_equal(
        linspace_f32(start, stop, n),
        np.asarray(jax.jit(lambda: jnp.linspace(start, stop, n,
                                                dtype=jnp.float32))()))


def test_loss_config_fields_match():
    assert dataclasses.asdict(LossConfig()) == \
        dataclasses.asdict(JaxLossConfig())
