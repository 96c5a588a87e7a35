"""Audio in, audio out: the port's pipeline against the JAX package's.

The narrow int8 DiT of ``torch_parity.py`` (random dense weights, AdaLN and
head non-zero, so its output moves with the initial noise) and a small
codec (latent 64, hop 8) with the JAX initializer's weights on both sides.
The noise comes from JAX: its draws are patched into the port's
``group_noise`` (one draw per group, ``fold_in(key, group)``) and
``_per_chunk_noise``.

Bounds: latents as ``test_torch_pipeline.py``'s pipeline test (relative L2
< 5e-2, max 6e-2: the DiT's cross-framework int8 code flips through CFG and
the last step); waveforms, after the decoder, relative L2 < 5e-2.  The
port's own identity, interleaved against two-phase under
``chunk_noise="batch"``, is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
from jatsr_tpu.infer import InferencePipeline as JaxPipeline
from jatsr_tpu.infer.pipeline import _per_chunk_noise as jax_chunk_noise
from jatsr_tpu.models.dac import DAC as JaxDAC
from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
from jatsr_tpu.models.dac.model import init_params as jax_dac_init
from jatsr_tpu.train.step import Normalizer as JaxNormalizer
from jatsr_torch.configs import SamplerConfig
from jatsr_torch.infer import InferencePipeline, chunk_plan
from jatsr_torch.infer import pipeline as torch_pipeline
from jatsr_torch.models.dac import DAC, DACConfig

from torch_parity import C, build_pair

CODEC = dict(encoder_dim=16, encoder_rates=(2, 4), decoder_dim=16,
             decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
             codebook_dim=4)  # latent 64 = C, hop 8
HOP = 8
# 64-frame chunks with 16 frames of overlap at hop 8.
SCFG = dict(num_steps=3, chunk_duration=64.5 * HOP / 44100,
            overlap_duration=16.5 * HOP / 44100)
KEY = 9
SEG = dict(segment_frames=60, ctx_frames=8)


@pytest.fixture(scope="module")
def setup():
    jmodel, jparams, tmodel, _ = build_pair("layer", seed=23)
    rng = np.random.default_rng(24)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2 else
             (0.1 * rng.standard_normal(C)).astype(np.float32)
             for i in range(4)]
    codec_p = jax.tree_util.tree_map(
        np.asarray, jax_dac_init(jax.random.PRNGKey(4),
                                 JaxDACConfig(**CODEC)))
    jcodec = JaxDAC(jax.tree_util.tree_map(jnp.asarray, codec_p),
                    JaxDACConfig(**CODEC))
    tcodec = DAC(codec_p, DACConfig(**CODEC), device="cpu")
    return jmodel, jparams, tmodel, stats, jcodec, tcodec


def _pipes(setup, **scfg):
    jmodel, jparams, tmodel, stats, jcodec, tcodec = setup
    jpipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats), jcodec,
                        JaxSamplerConfig(**SCFG, **scfg), hop_length=HOP)
    from jatsr_torch.train.step import Normalizer

    tpipe = InferencePipeline(tmodel, Normalizer(*stats, device="cpu"),
                              tcodec, SamplerConfig(**SCFG, **scfg),
                              hop_length=HOP, device="cpu")
    assert tpipe.chunk_frames == 64 and tpipe.overlap_frames == 16
    return jpipe, tpipe


def _jax_group_noise(seed, gi, shape, device):
    """JAX's draw of a group's noise: the sampler's ``normal(key)`` with
    the pipeline's ``fold_in(key, group)``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gi)
    return torch.from_numpy(np.asarray(jax.random.normal(
        key, tuple(shape), jnp.float32))).to(device)


def _jax_chunk_noise(seed, n, frames, channels, device):
    return torch.from_numpy(np.asarray(jax_chunk_noise(
        jax.random.PRNGKey(seed), n, frames, channels))).to(device)


def _lr(frames, seed=25):
    return np.random.default_rng(seed).standard_normal(
        (frames, C)).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-2


def test_batch_chunk_noise_matches_jax(setup, monkeypatch):
    """``chunk_noise="batch"``: one draw per group of ``max_batch``."""
    jpipe, tpipe = _pipes(setup, chunk_noise="batch")
    lr = _lr(150)
    want = jpipe.super_resolve_latent(lr, jax.random.PRNGKey(KEY),
                                      cfg_scale=2.0, max_batch=2)
    drawn = []
    monkeypatch.setattr(torch_pipeline, "group_noise",
                        lambda s, g, shape, d: (drawn.append(tuple(shape)),
                                                _jax_group_noise(s, g, shape,
                                                                 d))[1])
    got = tpipe.super_resolve_latent(lr, KEY, cfg_scale=2.0, max_batch=2)
    assert drawn == [(2, 64, C), (1, 64, C)]  # three chunks, two groups
    _close(got, want, 6e-2)


def test_pad_tail_group_matches_jax(setup, monkeypatch):
    """``pad_tail_group``: the tail group (one chunk) runs at batch 2 with a
    null chunk, whose output is dropped."""
    jpipe, tpipe = _pipes(setup, pad_tail_group=True)
    lr = _lr(150)
    want = jpipe.super_resolve_latent(lr, jax.random.PRNGKey(KEY),
                                      cfg_scale=2.0, max_batch=2)
    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", _jax_chunk_noise)
    batches = []
    sampler = tpipe.sampler
    tpipe.sampler = lambda g, *a, **k: (batches.append(g.shape[0]),
                                        sampler(g, *a, **k))[1]
    got = tpipe.super_resolve_latent(lr, KEY, cfg_scale=2.0, max_batch=2)
    assert batches == [2, 2]
    _close(got, want, 6e-2)


def test_interleaved_matches_jax(setup, monkeypatch):
    """``super_resolve_latent_to_audio``: four chunks in two groups, five
    decode segments, each group drawing its own noise as JAX's does."""
    jpipe, tpipe = _pipes(setup)
    lr = _lr(200)
    assert len(chunk_plan(200, 64, 16)) == 4
    want = jpipe.super_resolve_latent_to_audio(
        lr, jax.random.PRNGKey(KEY), cfg_scale=2.0, max_batch=2, **SEG)
    # JAX's two-phase path draws per chunk: on this model, whose output
    # moves with the noise, the two are not the same song.
    two_phase = jpipe.decode_latent(jpipe.super_resolve_latent_device(
        lr, jax.random.PRNGKey(KEY), cfg_scale=2.0, max_batch=2), **SEG)
    assert np.linalg.norm(two_phase - want) / np.linalg.norm(want) > 5e-2
    monkeypatch.setattr(torch_pipeline, "group_noise", _jax_group_noise)
    got = tpipe.super_resolve_latent_to_audio(lr, KEY, cfg_scale=2.0,
                                              max_batch=2, **SEG)
    assert got.shape == want.shape == (200 * HOP,)
    _close(got, want, 5e-2)


@pytest.mark.parametrize("max_batch", [2, 0])
def test_interleaved_equals_two_phase_under_batch_noise(setup, max_batch):
    """Under ``chunk_noise="batch"`` both paths draw per group: the
    incremental crossfade and the decode windows give the two-phase result
    bit for bit."""
    _, tpipe = _pipes(setup, chunk_noise="batch")
    lr = _lr(200, seed=26)
    got = tpipe.super_resolve_latent_to_audio(lr, 3, cfg_scale=2.0,
                                              max_batch=max_batch, **SEG)
    want = tpipe.decode_latent(tpipe.super_resolve_latent_device(
        lr, 3, cfg_scale=2.0, max_batch=max_batch), **SEG)
    np.testing.assert_array_equal(got, want)


def test_super_resolve_audio_matches_jax(setup, monkeypatch):
    """16 kHz audio in: resampled to 44.1 kHz and encoded (200 frames, one
    decode segment at the default 2756: the two-phase branch, with
    per-chunk noise, on both sides)."""
    jpipe, tpipe = _pipes(setup)
    audio = (0.3 * np.random.default_rng(27).standard_normal(580)
             ).astype(np.float32)
    lat_j = jpipe.encode_lr_audio(audio, 16000)
    lat_t = tpipe.encode_lr_audio(audio, 16000)
    assert lat_t.shape == lat_j.shape == (-(-1599 // HOP), C)
    np.testing.assert_allclose(lat_t, lat_j,
                               atol=1e-5 * np.abs(lat_j).max())
    want = jpipe.super_resolve_audio(audio, 16000, jax.random.PRNGKey(KEY),
                                     cfg_scale=2.0, max_batch=2)
    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", _jax_chunk_noise)
    got = tpipe.super_resolve_audio(audio, 16000, KEY, cfg_scale=2.0,
                                    max_batch=2)
    assert got.shape == want.shape == (lat_j.shape[0] * HOP,)
    _close(got, want, 5e-2)
