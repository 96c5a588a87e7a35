"""The port's Heun solver, its re-noising sampler, and the bf16 DiT served
through its sampler, against the JAX package.

- Heun and ``renoise_sample`` driving the JAX model (the narrow int8 DiT of
  ``torch_parity.py``), with the same initial noise on both sides (JAX's
  draws patched into ``renoise_draw``): bit-equal, so the schedule, the
  second velocity at ``t_next`` with the table at ``i + 1``, the Euler fall
  back on the last interval, CFG and the re-noising agree.  The port skips
  the second forward that JAX computes and throws away on that interval:
  ``2n - 1`` forwards for n steps.
- Heun end to end (the port's DiT in the port's sampler): the bounds of
  ``test_torch_pipeline.py``'s sampler tests, relative L2 < 5e-2 and max
  error 5e-2.
- The bf16 ``DenseDiT`` (``tiny``, random dense weights) through the
  sampler with hoisted AdaLN tables against ``DiT.apply`` with JAX's tables:
  the tables agree within two bf16 ulps of their largest entry (each side
  rounds the product and then the bias add, with fp32 sums in its own
  order: both within 1.4 ulps of the float64 value); the sampled latents
  within 2e-2 of their scale (bf16 products summed in another order,
  through 4 steps and CFG 2.0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.models.dit import adaln_tables as jax_adaln_tables
from jatsr_tpu.ops import attention as jattn
from jatsr_tpu.sampling import FlowSampler as JaxFlowSampler
from jatsr_torch.configs import SamplerConfig, get_preset
from jatsr_torch.models.dit import DenseDiT, adaln_tables
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.sampling import FlowSampler
from jatsr_torch.sampling import flow as torch_flow

from torch_parity import C, Spy, build_pair

STEPS = 4
# (cfg_scale, cfg_batching, cfg_interval): no CFG, both batchings, and CFG
# on steps 1-2 of 4 only.
MODES = {"nocfg": (1.0, "doubled", (0.0, 1.0)),
         "doubled": (2.0, "doubled", (0.0, 1.0)),
         "split": (2.0, "split", (0.0, 1.0)),
         "interval": (2.0, "doubled", (0.25, 0.75))}


@pytest.fixture(scope="module")
def pair():
    return build_pair("layer", seed=21)


def _inputs(frames=64, channels=C, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, frames, channels), dtype=np.float32),
            rng.standard_normal((2, frames, channels), dtype=np.float32))


def _jax_sampler(jmodel, jparams, scfg):
    return JaxFlowSampler(
        lambda p, z, t, c, mod=None: jmodel.apply(
            {"params": p}, z, t, c, adaln_mod=mod),
        scfg, params=jparams,
        adaln_fn=lambda p, tv: jax_adaln_tables(jmodel.cfg, p, tv))


class _JaxModel:
    """The JAX model as the port's sampler calls it; counts forwards."""

    def __init__(self, jmodel, jparams):
        self.jmodel, self.jparams, self.calls = jmodel, jparams, 0
        self.apply = jax.jit(lambda p, z, t, c, mod=None: jmodel.apply(
            {"params": p}, z, t, c, adaln_mod=mod))

    def __call__(self, z, t, c, mod):
        self.calls += 1
        mod = None if mod is None else jnp.asarray(mod.float().numpy(),
                                                   jnp.bfloat16)
        out = self.apply(self.jparams, jnp.asarray(z.numpy()),
                         jnp.asarray(t.numpy()), jnp.asarray(c.numpy()), mod)
        return torch.from_numpy(np.array(out))

    def tables(self, tv):
        t = jax_adaln_tables(self.jmodel.cfg, self.jparams,
                             jnp.asarray(tv.numpy()))
        return torch.from_numpy(np.asarray(t, np.float32)).bfloat16()


def _cfgs(mode):
    scale, batching, interval = MODES[mode]
    kw = dict(num_steps=STEPS, solver="heun", cfg_batching=batching,
              cfg_interval=interval)
    return scale, JaxSamplerConfig(**kw), SamplerConfig(**kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_heun_math_is_exact(pair, mode):
    jmodel, jparams, _, _ = pair
    scale, jcfg, tcfg = _cfgs(mode)
    cond, z0 = _inputs()
    want = _jax_sampler(jmodel, jparams, jcfg)(
        jax.random.PRNGKey(0), jnp.asarray(cond), STEPS, scale,
        z0=jnp.asarray(z0))
    model = _JaxModel(jmodel, jparams)
    got = FlowSampler(model, tcfg, adaln_fn=model.tables, device="cpu")(
        torch.from_numpy(cond), STEPS, scale, z0=torch.from_numpy(z0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # 2n - 1 velocities; split CFG takes two forwards for each guided one.
    guided = {"nocfg": 0, "doubled": 0, "split": 2 * STEPS - 1,
              "interval": 0}[mode]
    assert model.calls == 2 * STEPS - 1 + guided


def test_heun_matches_jax(pair):
    """The port's DiT in the port's Heun sampler against JAX's, CFG 2.0."""
    jmodel, jparams, tmodel, _ = pair
    scale, jcfg, tcfg = _cfgs("doubled")
    cond, z0 = _inputs()
    want = np.asarray(_jax_sampler(jmodel, jparams, jcfg)(
        jax.random.PRNGKey(0), jnp.asarray(cond), STEPS, scale,
        z0=jnp.asarray(z0)))
    got = FlowSampler(
        lambda z, t, c, mod=None: tmodel(z, t, c, adaln_mod=mod), tcfg,
        adaln_fn=lambda tv: adaln_tables(tmodel, tv), device="cpu")(
        torch.from_numpy(cond), STEPS, scale,
        z0=torch.from_numpy(z0)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-2)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-2


def test_renoise_sample_math_is_exact(pair, monkeypatch):
    jmodel, jparams, _, _ = pair
    cond, _ = _inputs()
    key = jax.random.PRNGKey(7)
    want = _jax_sampler(jmodel, jparams, JaxSamplerConfig()).renoise_sample(
        key, jnp.asarray(cond), STEPS)
    drawn = []

    def jax_draw(generator, shape, i, device):
        drawn.append(i)
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), tuple(shape), jnp.float32)))

    monkeypatch.setattr(torch_flow, "renoise_draw", jax_draw)
    model = _JaxModel(jmodel, jparams)
    got = FlowSampler(model, SamplerConfig(), adaln_fn=model.tables,
                      device="cpu").renoise_sample(
        torch.Generator(), torch.from_numpy(cond), STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert drawn == [STEPS + 1] + list(range(STEPS)) and model.calls == STEPS


def test_renoise_sample_draws_from_its_generator(pair):
    _, _, tmodel, _ = pair
    cond = torch.from_numpy(_inputs()[0])
    sampler = FlowSampler(lambda z, t, c, mod=None: tmodel(z, t, c),
                          SamplerConfig(), device="cpu")
    a, b, c = (sampler.renoise_sample(torch.Generator().manual_seed(s), cond,
                                      2) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _tiny(getter, **kw):
    return dataclasses.replace(getter("tiny").model, **kw)


@pytest.mark.parametrize("impl,kernel", [("xla", None),
                                         ("flash", "gqa_attention_flash")])
def test_dense_dit_through_the_sampler_matches_jax(impl, kernel,
                                                   monkeypatch):
    """The bf16 model served as the JAX CLI serves it by default: the
    sampler with hoisted tables, the deterministic attention of its
    branch (the einsum, or the split flash kernel: JAX in interpret mode,
    the port's plain version)."""
    spies = [Spy(monkeypatch, kernel, m) for m in (jattn, None)] \
        if kernel else []
    tcfg = _tiny(get_preset, attention_impl=impl)
    dense = random_dense_params(tcfg, 17)
    jmodel = JaxDiT(_tiny(jax_get_preset, attention_impl=impl))
    jparams = jax.tree_util.tree_map(jnp.asarray, dense)
    model = DenseDiT(tcfg, dense, device="cpu")
    tv = torch.from_numpy(torch_flow.timesteps(STEPS))
    want_t = np.asarray(jax_adaln_tables(jmodel.cfg, jparams,
                                         jnp.asarray(tv.numpy())), np.float32)
    got_t = adaln_tables(model, tv).float().numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=0,
                               atol=2 ** -7 * np.abs(want_t).max())

    cond, z0 = _inputs(channels=1024, seed=12)
    scfg = dict(num_steps=STEPS)
    want = np.asarray(_jax_sampler(jmodel, jparams, JaxSamplerConfig(**scfg))(
        jax.random.PRNGKey(0), jnp.asarray(cond), STEPS, 2.0,
        z0=jnp.asarray(z0)))
    got = FlowSampler(
        lambda z, t, c, mod=None: model(z, t, c, adaln_mod=mod),
        SamplerConfig(**scfg), adaln_fn=lambda t: adaln_tables(model, t),
        device="cpu")(torch.from_numpy(cond), STEPS, 2.0,
                      z0=torch.from_numpy(z0)).numpy()
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)
    for spy in spies:
        assert spy.calls  # both sides took the kernel's branch
