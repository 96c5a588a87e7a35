"""The port's sampler, chunked pipeline and DAC decode against the JAX
package, on the narrow DiT of ``torch_parity.py``.

The initial noise comes from the JAX side (numpy arrays) on both: torch
cannot reproduce JAX's PRNG streams.  The sampler's and the pipeline's own
arithmetic is held bit for bit, by driving them with the JAX model.  End to
end, with the port's DiT inside, the JAX package's pipeline criterion
(``tests/test_trainer_and_infer.py``: relative L2 < 5e-2) holds; the
max-abs bound is stated per test: small activation-quantisation flips (see
``test_torch_dit.py``) are amplified by the CFG extrapolation and the last
Euler step.  The DAC decode is fp32 convolutions on both sides: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
from jatsr_tpu.infer import InferencePipeline as JaxPipeline
from jatsr_tpu.infer.pipeline import _per_chunk_noise as jax_chunk_noise
from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
from jatsr_tpu.models.dac.model import decoder_forward as jax_decoder_forward
from jatsr_tpu.models.dac.model import init_params as jax_dac_init
from jatsr_tpu.models.dit import adaln_tables as jax_adaln_tables
from jatsr_tpu.sampling import FlowSampler as JaxFlowSampler
from jatsr_tpu.train.step import Normalizer as JaxNormalizer
from jatsr_torch.configs import SamplerConfig
from jatsr_torch.infer import InferencePipeline, chunk_plan
from jatsr_torch.infer import pipeline as torch_pipeline
from jatsr_torch.models.dac import DAC, DACConfig
from jatsr_torch.models.dit import adaln_tables
from jatsr_torch.sampling import FlowSampler
from jatsr_torch.sampling.flow import timesteps
from jatsr_torch.train.step import Normalizer

from torch_parity import C, build_pair

# bench.py's --quick codec: latent 1024, hop 8.
SMALL_DAC = dict(encoder_dim=256, encoder_rates=(2, 4), decoder_dim=16,
                 decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
                 codebook_dim=4)


def _assert_close(got, want, atol=2e-2):
    np.testing.assert_allclose(got, want, atol=atol)
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)
    assert rel < 5e-2, rel


@pytest.fixture(scope="module")
def pair():
    return build_pair("layer", seed=5)


@pytest.mark.parametrize("n", [4, 8, 50])
def test_timesteps_match_jax_linspace(n):
    np.testing.assert_array_equal(
        timesteps(n), np.asarray(jnp.linspace(0.0, 1.0, n + 1,
                                              dtype=jnp.float32)))


def _jax_sampler(jmodel, jparams, batching):
    return JaxFlowSampler(
        lambda p, z, t, c, mod=None: jmodel.apply({"params": p}, z, t, c,
                                                  adaln_mod=mod),
        JaxSamplerConfig(num_steps=4, cfg_batching=batching), params=jparams,
        adaln_fn=lambda p, tv: jax_adaln_tables(jmodel.cfg, p, tv))


def _sampler_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2, 64, C), dtype=np.float32),
            rng.standard_normal((2, 64, C), dtype=np.float32))


@pytest.mark.parametrize("batching", ["doubled", "split"])
def test_flow_sampler_math_is_exact(pair, batching):
    """The port's sampler driving the JAX model gives the JAX sampler's
    result bit for bit: schedule, CFG, guard, jump and tables agree."""
    jmodel, jparams, _, _ = pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, batching)(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))

    def model(z, t, c, mod):
        out = jmodel.apply({"params": jparams}, jnp.asarray(z.numpy()),
                           jnp.asarray(t.numpy()), jnp.asarray(c.numpy()),
                           adaln_mod=jnp.asarray(mod.float().numpy(),
                                                 jnp.bfloat16))
        return torch.from_numpy(np.asarray(out))

    def tables(tv):
        t = jax_adaln_tables(jmodel.cfg, jparams, jnp.asarray(tv.numpy()))
        return torch.from_numpy(np.asarray(t, np.float32)).bfloat16()

    sampler = FlowSampler(model, SamplerConfig(num_steps=4,
                                               cfg_batching=batching),
                          adaln_fn=tables, device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batching", ["doubled", "split"])
def test_flow_sampler_matches_jax(pair, batching):
    """Port DiT + port sampler against JAX DiT + JAX sampler.  The DiT's
    few-ulp differences pass through CFG 2.0 (x3) and the last step's
    z -> x_pred: max error 5e-2 (measured 3.5e-2), relative L2 < 5e-2
    (measured 1.8e-2)."""
    jmodel, jparams, tmodel, _ = pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, batching)(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4, cfg_batching=batching),
        adaln_fn=lambda tv: adaln_tables(tmodel, tv), device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    assert got.shape == cond.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), np.asarray(want), atol=5e-2)


def _pipeline_case(jmodel, jparams):
    """150 frames in 64-frame chunks with 16 frames of overlap: three
    chunks, a padded tail, two groups of max_batch 2, crossfaded."""
    rng = np.random.default_rng(12)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2 else
             rng.standard_normal(C).astype(np.float32) for i in range(4)]
    lr = rng.standard_normal((150, C)).astype(np.float32)
    kw = dict(num_steps=4, chunk_duration=64 * 512 / 44100,
              overlap_duration=16 * 512 / 44100)
    key = jax.random.PRNGKey(9)
    jpipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats),
                        sampler_cfg=JaxSamplerConfig(**kw))
    want = jpipe.super_resolve_latent(lr, key, cfg_scale=2.0, max_batch=2)

    def jax_noise(seed, n, frames, channels, device):
        return torch.from_numpy(np.asarray(
            jax_chunk_noise(key, n, frames, channels))).to(device)

    return stats, lr, kw, jax_noise, want


def test_super_resolve_latent_math_is_exact(pair, monkeypatch):
    """The port's pipeline driving the JAX model (and JAX's AdaLN tables
    and noise) gives the JAX pipeline's result bit for bit: normalize,
    tail pad, chunking, grouping, denormalize and crossfade agree."""
    jmodel, jparams, _, _ = pair
    stats, lr, kw, jax_noise, want = _pipeline_case(jmodel, jparams)

    class JaxModel:
        def __call__(self, z, t, c, adaln_mod=None):
            out = jmodel.apply(
                {"params": jparams}, jnp.asarray(z.numpy()),
                jnp.asarray(t.numpy()), jnp.asarray(c.numpy()),
                adaln_mod=jnp.asarray(adaln_mod.float().numpy(),
                                      jnp.bfloat16))
            return torch.from_numpy(np.array(out))

    def tables(model, tv):
        t = jax_adaln_tables(jmodel.cfg, jparams, jnp.asarray(tv.numpy()))
        return torch.from_numpy(np.asarray(t, np.float32)).bfloat16()

    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", jax_noise)
    monkeypatch.setattr(torch_pipeline, "adaln_tables", tables)
    pipe = InferencePipeline(JaxModel(), Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**kw), device="cpu")
    got = pipe.super_resolve_latent(lr, 0, cfg_scale=2.0, max_batch=2)
    assert len(chunk_plan(150, pipe.chunk_frames, pipe.overlap_frames)) == 3
    np.testing.assert_array_equal(got, want)


def test_super_resolve_latent_matches_jax(pair, monkeypatch):
    """The port end to end (its DiT inside its pipeline) against the JAX
    pipeline.  Relative L2 < 5e-2 as in the JAX package's own pipeline
    test; the max error is 6e-2, not that test's 2e-2: the DiT's few-ulp
    cross-framework differences (test_torch_dit.py) pass through CFG 2.0
    (x3), the last Euler step and the denormalize (std up to 1.5).
    Measured: max 4.0e-2 on 1% of the entries."""
    jmodel, jparams, tmodel, _ = pair
    stats, lr, kw, jax_noise, want = _pipeline_case(jmodel, jparams)
    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", jax_noise)
    pipe = InferencePipeline(tmodel, Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**kw), device="cpu")
    got = pipe.super_resolve_latent(lr, 0, cfg_scale=2.0, max_batch=2)
    assert got.shape == (150, C)
    _assert_close(got, want, atol=6e-2)


def test_per_chunk_noise_does_not_depend_on_grouping():
    a = torch_pipeline._per_chunk_noise(3, 4, 10, 8, "cpu")
    b = torch_pipeline._per_chunk_noise(3, 2, 10, 8, "cpu")
    torch.testing.assert_close(a[:2], b, atol=0, rtol=0)
    assert not torch.equal(a[0], a[1])


def test_dac_decoder_matches_jax():
    jcfg = JaxDACConfig(**SMALL_DAC)
    dec = jax.tree_util.tree_map(
        np.asarray, jax_dac_init(jax.random.PRNGKey(3), jcfg)["decoder"])
    z = np.random.default_rng(13).standard_normal((2, 40, 1024)) \
        .astype(np.float32)
    want = jax_decoder_forward({"decoder": dec}, jnp.asarray(z), jcfg)
    got = DAC(dec, DACConfig(**SMALL_DAC), device="cpu").decode(
        torch.from_numpy(z))
    assert got.shape == (2, 40 * 8, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_latent_pieces_join_into_whole_decode():
    """Segments (64 frames, 32 of context: beyond the small decoder's ~20
    frame receptive field) join into the unsegmented decode, the final one
    anchored at the end; decode_batch groups do not change the result."""
    cfg = DACConfig(**SMALL_DAC)
    codec = DAC.random_init(0, cfg, device="cpu")
    pipe = InferencePipeline.__new__(InferencePipeline)
    pipe.codec, pipe.hop, pipe.device = codec, cfg.hop_length, \
        torch.device("cpu")
    z = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (300, 1024)).astype(np.float32))
    whole = codec.decode(z[None])[0, :, 0]
    pieces = pipe.decode_latent_pieces(z, segment_frames=64, ctx_frames=32)
    assert len(pieces) == 5
    torch.testing.assert_close(torch.cat(pieces), whole, atol=2e-5, rtol=0)
    batched = pipe.decode_latent(z, segment_frames=64, ctx_frames=32,
                                 decode_batch=2)
    np.testing.assert_allclose(batched, whole.numpy(), atol=2e-5)


PROLOGUE = dict(fused_prologue=True, align_n=True)


@pytest.fixture(scope="module")
def prologue_pair():
    return build_pair("rms", seed=15, **PROLOGUE)


def test_flow_sampler_with_prologue_matches_jax(prologue_pair):
    """The fused-prologue DiT (64 frames: 16 patches, no padding) under
    the doubled-CFG sampler with hoisted ``[depth, 1, 6H]`` tables, against
    JAX; the bounds of test_flow_sampler_matches_jax."""
    jmodel, jparams, tmodel, _ = prologue_pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, "doubled")(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4), adaln_fn=lambda tv: adaln_tables(tmodel, tv),
        device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    _assert_close(got.numpy(), np.asarray(want), atol=5e-2)


def test_super_resolve_latent_device_with_prologue_matches_jax(
        prologue_pair, monkeypatch):
    """The port's pipeline with the fused-prologue DiT against the JAX
    pipeline; 66-frame chunks pad to 17 patches and align to 24, so every
    forward runs the key mask.  The bounds of
    test_super_resolve_latent_matches_jax."""
    jmodel, jparams, tmodel, _ = prologue_pair
    rng = np.random.default_rng(16)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2 else
             rng.standard_normal(C).astype(np.float32) for i in range(4)]
    lr = rng.standard_normal((150, C)).astype(np.float32)
    kw = dict(num_steps=4, chunk_duration=66 * 512 / 44100,
              overlap_duration=16 * 512 / 44100)
    key = jax.random.PRNGKey(17)
    jpipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats),
                        sampler_cfg=JaxSamplerConfig(**kw))
    want = jpipe.super_resolve_latent(lr, key, cfg_scale=2.0, max_batch=2)

    def jax_noise(seed, n, frames, channels, device):
        return torch.from_numpy(np.array(
            jax_chunk_noise(key, n, frames, channels))).to(device)

    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", jax_noise)
    pipe = InferencePipeline(tmodel, Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**kw), device="cpu")
    assert pipe.chunk_frames == 66
    got = pipe.super_resolve_latent_device(torch.from_numpy(lr), 0,
                                           cfg_scale=2.0, max_batch=2)
    assert got.shape == (150, C)
    _assert_close(got.numpy(), want, atol=6e-2)


OPT_IN = dict(PROLOGUE, flash_fused_out=True, fused_mlp_impl="full",
              int8_impl="pallas")


@pytest.fixture(scope="module")
def opt_in_pair():
    return build_pair("layer", seed=18, **OPT_IN)


def test_flow_sampler_with_opt_in_kernels_matches_jax(opt_in_pair):
    """``bench.py --flash-out --fused-mlp-impl full --int8-impl pallas``'s
    DiT (the fused out projection, the whole-MLP kernel, the s8 qkv product
    on a pre-quantised A) under the doubled-CFG sampler with hoisted
    tables, against JAX; the bounds of test_flow_sampler_matches_jax."""
    jmodel, jparams, tmodel, _ = opt_in_pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, "doubled")(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4), adaln_fn=lambda tv: adaln_tables(tmodel, tv),
        device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    _assert_close(got.numpy(), np.asarray(want), atol=5e-2)


def test_super_resolve_latent_device_with_opt_in_kernels_matches_jax(
        opt_in_pair, monkeypatch):
    """The port's pipeline with that DiT against the JAX pipeline; 66-frame
    chunks (17 patches, aligned to 24: every forward masks keys).  The
    bounds of test_super_resolve_latent_matches_jax."""
    jmodel, jparams, tmodel, _ = opt_in_pair
    rng = np.random.default_rng(19)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2 else
             rng.standard_normal(C).astype(np.float32) for i in range(4)]
    lr = rng.standard_normal((150, C)).astype(np.float32)
    kw = dict(num_steps=4, chunk_duration=66 * 512 / 44100,
              overlap_duration=16 * 512 / 44100)
    key = jax.random.PRNGKey(20)
    jpipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats),
                        sampler_cfg=JaxSamplerConfig(**kw))
    want = jpipe.super_resolve_latent(lr, key, cfg_scale=2.0, max_batch=2)

    def jax_noise(seed, n, frames, channels, device):
        return torch.from_numpy(np.array(
            jax_chunk_noise(key, n, frames, channels))).to(device)

    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", jax_noise)
    pipe = InferencePipeline(tmodel, Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**kw), device="cpu")
    got = pipe.super_resolve_latent_device(torch.from_numpy(lr), 0,
                                           cfg_scale=2.0, max_batch=2)
    assert got.shape == (150, C)
    _assert_close(got.numpy(), want, atol=6e-2)


@pytest.fixture(scope="module")
def pallas_pair():
    return build_pair("layer", seed=24, **PROLOGUE, attention_impl="pallas")


def test_flow_sampler_with_per_head_attention_matches_jax(pallas_pair):
    """``bench.py --attention pallas``'s DiT (the fused prologue and align_n
    asked for, neither taken: the split q/k/v and the per-q-head attention
    kernel on 16 patches) under the doubled-CFG sampler with hoisted
    tables, against JAX; the bounds of test_flow_sampler_matches_jax."""
    jmodel, jparams, tmodel, _ = pallas_pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, "doubled")(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4), adaln_fn=lambda tv: adaln_tables(tmodel, tv),
        device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    _assert_close(got.numpy(), np.asarray(want), atol=5e-2)


CLI_INT8 = dict(fused_mlp=False, quantize_head=True, attention_impl="xla",
                fused_qkv=False)


@pytest.fixture(scope="module")
def cli_int8_pair():
    from test_torch_dit import _build_knobs

    return _build_knobs(CLI_INT8, seed=26, norm="layer")


def test_flow_sampler_with_unfused_int8_branches_matches_jax(cli_int8_pair):
    """The int8 DiT on its unfused branches (q/k/v projections apart, the
    QuantDense MLP, the int8 head, the einsum attention) under the
    doubled-CFG sampler with hoisted tables, against JAX; the bounds of
    test_flow_sampler_matches_jax."""
    jmodel, jparams, tmodel, _ = cli_int8_pair
    cond, z0 = _sampler_inputs()
    want = _jax_sampler(jmodel, jparams, "doubled")(
        jax.random.PRNGKey(0), jnp.asarray(cond), 4, 2.0, z0=jnp.asarray(z0))
    sampler = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod),
        SamplerConfig(num_steps=4), adaln_fn=lambda tv: adaln_tables(tmodel, tv),
        device="cpu")
    got = sampler(torch.from_numpy(cond), 4, 2.0, z0=torch.from_numpy(z0))
    _assert_close(got.numpy(), np.asarray(want), atol=5e-2)


def test_super_resolve_latent_device_with_unfused_int8_branches_matches_jax(
        cli_int8_pair, monkeypatch):
    """The port's pipeline with that DiT against the JAX pipeline (66-frame
    chunks); the bounds of test_super_resolve_latent_matches_jax."""
    jmodel, jparams, tmodel, _ = cli_int8_pair
    rng = np.random.default_rng(27)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2 else
             rng.standard_normal(C).astype(np.float32) for i in range(4)]
    lr = rng.standard_normal((150, C)).astype(np.float32)
    kw = dict(num_steps=4, chunk_duration=66 * 512 / 44100,
              overlap_duration=16 * 512 / 44100)
    key = jax.random.PRNGKey(28)
    jpipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats),
                        sampler_cfg=JaxSamplerConfig(**kw))
    want = jpipe.super_resolve_latent(lr, key, cfg_scale=2.0, max_batch=2)

    def jax_noise(seed, n, frames, channels, device):
        return torch.from_numpy(np.array(
            jax_chunk_noise(key, n, frames, channels))).to(device)

    monkeypatch.setattr(torch_pipeline, "_per_chunk_noise", jax_noise)
    pipe = InferencePipeline(tmodel, Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**kw), device="cpu")
    got = pipe.super_resolve_latent_device(torch.from_numpy(lr), 0,
                                           cfg_scale=2.0, max_batch=2)
    assert got.shape == (150, C)
    _assert_close(got.numpy(), want, atol=6e-2)
