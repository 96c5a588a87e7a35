"""The port's training slice against the JAX package: schedule, optimizer,
the trainable DiT's forward and gradients, whole train steps fed the JAX
step's own draws, the eval step, and remat.

JAX takes the training attention kernel (B10) in Pallas interpret mode here:
off a TPU its model takes the einsum path unless ``ALLOW_INTERPRET_DISPATCH``
is set, so the tests set it (monkeypatch) to compare the branch the port
takes.  Tolerances:

- schedule and optimizer on identical fp32 inputs: rtol 1e-6 (the bf16
  first moment: one bf16 ulp); with bf16 parameters and gradients the
  optimizer is bit-equal to optax (eager JAX rounds each operation as the
  port does);
- the bf16 DiT: loss rtol 1e-2, grads normalised by their max atol 3e-2
  (the JAX package's own bound for B10 against its einsum path,
  ``tests/test_attention_train.py``);
- whole steps: the same on the metrics; an updated parameter differs from
  JAX's by at most 2 lr (Adam's step is lr * m / sqrt(v), +-lr on a first
  step, so a gradient whose sign differs in bf16 moves it the other way),
  and by less than 2 % of lr on average.

The latent perceptual loss's log-magnitude term has the gradient
``1 / |rfft(pred)|`` at each bin, so at random weights a few near-zero bins
dominate it and one bf16 ulp of the prediction moves it by tens of percent
(the same JAX loss at the JAX model's and at the port's prediction: gradient
norms 0.95 and 0.37).  So the steps compare gradients and parameters under
the MSE loss, and the perceptual stack's values; its gradients are compared
on identical inputs (``test_loss_gradients_match_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops import attention_train as jat
from jatsr_tpu.sampling import flow as jflow
from jatsr_tpu.train import create_train_state as jax_create_state
from jatsr_tpu.train import make_eval_step as jax_eval_step
from jatsr_tpu.train import make_train_step as jax_train_step
from jatsr_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from jatsr_tpu.train.state import make_optimizer as jax_make_optimizer
from jatsr_tpu.train.step import Normalizer as JaxNormalizer
from jatsr_tpu.utils import flops as jflops
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import (dense_tree_from_module,
                                         init_dense_params,
                                         random_dense_params)
from jatsr_torch.sampling.flow import (flow_interpolate, u_shaped,
                                       u_shaped_timesteps)
from jatsr_torch.train import (create_train_state, make_eval_step,
                               make_optimizer, make_train_step)
from jatsr_torch.train.schedule import warmup_cosine
from jatsr_torch.train.step import Normalizer
from jatsr_torch.utils import flops

B, T, C = 4, 24, 1024


@pytest.fixture
def jax_flash(monkeypatch):
    monkeypatch.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_grads(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=3e-2,
                                   err_msg=k)


def test_schedule_matches_jax():
    for warmup, total in ((10, 100), (0, 50), (1000, 300000)):
        want = jax_warmup_cosine(5e-5, warmup, total)
        got = warmup_cosine(5e-5, warmup, total)
        for s in (0, 1, 5, 9, 10, 11, 49, 50, 99, 100, 150, 2000, 299999):
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.01])
def test_optimizer_matches_optax(moments, grad_scale, param_dtype):
    """clip_by_global_norm + adamw under warmup-cosine, three updates on
    identical grads (grad_scale 1.0 clips, 0.01 does not), on fp32 or bf16
    parameters and gradients.  bf16: the clip norm in bf16 over the leaves
    in the JAX tree's order (``leaf_groups``), ``nu`` bf16, ``mu`` in
    ``mu_dtype``, the new parameter rounded once; every leaf's values and
    dtypes equal to optax's."""
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig

    from jatsr_torch.configs import TrainConfig
    from jatsr_torch.train.state import leaf_groups

    kw = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1, grad_clip=1.0,
              adam_moments_dtype=moments)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((8, 16), dtype=np.float32),
          "b": rng.standard_normal((16,), dtype=np.float32)}
    grads = [{k: grad_scale * rng.standard_normal(v.shape, dtype=np.float32)
              for k, v in p0.items()} for _ in range(3)]
    jdt, tdt = jnp.dtype(param_dtype), getattr(torch, param_dtype)

    tx = jax_make_optimizer(JaxTrainConfig(**kw), 20)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    js = tx.init(jp)
    opt = make_optimizer(TrainConfig(**kw), 20)
    keys = sorted(p0)
    tp = [torch.from_numpy(p0[k].copy()).to(tdt) for k in keys]
    ts = opt.init(tp)
    for g in grads:
        u, js = tx.update(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jdt), g), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, [torch.from_numpy(g[k]).to(tdt) for k in keys], ts,
                 leaf_groups(keys))
    adam = js[1][0]
    if param_dtype == "bfloat16":
        for i, k in enumerate(keys):
            for got, want in ((tp[i], jp[k]), (ts.nu[i], adam.nu[k]),
                              (ts.mu[i], adam.mu[k])):
                assert str(got.dtype).endswith(str(want.dtype)), k
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(want, np.float32),
                                              err_msg=k)
        assert ts.count == int(adam.count) == 3
        return
    for i, k in enumerate(keys):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ts.nu[i].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        want_mu = np.asarray(adam.mu[k], np.float32)
        # mu cancels towards 0 where grads change sign: its error is taken
        # against the leaf's scale.
        np.testing.assert_allclose(
            ts.mu[i].float().numpy(), want_mu,
            rtol=1e-6 if moments == "float32" else 2.0 ** -7,
            atol=1e-6 * np.abs(want_mu).max(), err_msg=k)
        assert str(ts.mu[i].dtype).endswith(moments)
    assert ts.count == int(adam.count) == 3


def test_u_shaped_timesteps_on_the_cpu_when_asked():
    gen = torch.Generator().manual_seed(3)
    t = u_shaped_timesteps(1000, generator=gen, device="cpu")
    assert t.shape == (1000,) and t.dtype == torch.float32
    assert t.device.type == "cpu"
    assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0


def test_u_shaped_timesteps_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        u_shaped_timesteps(4)


def test_flow_draws_match_jax():
    rng = np.random.default_rng(1)
    u = rng.random(64, dtype=np.float32)
    np.testing.assert_allclose(
        u_shaped(torch.from_numpy(u), 0.5).numpy(),
        np.asarray(jnp.where(u < 0.5, 0.5 * (2.0 * u) ** 0.5,
                             1.0 - 0.5 * (2.0 * (1.0 - u)) ** 0.5)),
        rtol=1e-6)
    x0, nz = (rng.standard_normal((4, 5, 3), dtype=np.float32)
              for _ in range(2))
    t = rng.random(4, dtype=np.float32)
    np.testing.assert_allclose(
        flow_interpolate(*map(torch.from_numpy, (x0, nz, t))).numpy(),
        np.asarray(jflow.flow_interpolate(x0, nz, t)), rtol=1e-6, atol=1e-7)


def test_flops_match_jax():
    cfg = get_preset("v3mod2").model
    jcfg = jax_get_preset("v3mod2").model
    assert flops.dit_forward_flops(cfg, 28, 1378) == \
        jflops.dit_forward_flops(jcfg, 28, 1378)
    assert flops.train_step_flops(cfg, 28, 1378, 2) == \
        jflops.train_step_flops(jcfg, 28, 1378, 2)
    assert flops.H100_BF16_PEAK_FLOPS == 989e12


def _tiny(preset_getter, **kw):
    return dataclasses.replace(preset_getter("tiny").model, **kw)


def test_dense_dit_matches_jax_training_forward(jax_flash):
    """The trainable DiT on its training path (B10's plain versions) against
    JAX ``DiT.apply(deterministic=False)`` through B10 in interpret mode:
    45 patches, so the kernel pads to 48 and masks."""
    tcfg = _tiny(get_preset)
    dense = random_dense_params(tcfg, 0)
    rng = np.random.default_rng(1)
    x, c = (rng.standard_normal((2, 45 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.3, 0.8], np.float32)

    def jloss(p):
        out = JaxDiT(_tiny(jax_get_preset)).apply(
            {"params": p}, x, t, c, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.mean(out ** 2)

    l_j, g_j = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, dense))
    model = DenseDiT(tcfg, dense, device="cpu")
    out = model(*map(torch.from_numpy, (x, t, c)), deterministic=False,
                layer_seeds=[11, -12])
    loss = (out ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-2)
    g_t = dense_tree_from_module(_GradView(model))
    _assert_grads(g_t, g_j)


class _GradView:
    """A DenseDiT seen through its parameters' gradients."""

    def __init__(self, model):
        self.cfg = model.cfg
        self._m = model

    def named_parameters(self):
        return [(k, v.grad) for k, v in self._m.named_parameters()]


def _stats(rng):
    mu = 0.1 * rng.standard_normal(C).astype(np.float32)
    sd = (0.5 + rng.random(C)).astype(np.float32)
    return mu, sd, -mu, 2 * sd


def _jax_state(tcfg_j, dense, hr, lr):
    state = jax_create_state(JaxDiT(_tiny(jax_get_preset)), tcfg_j,
                             total_steps=100, sample_batch=(hr, lr))
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    return state.replace(params=params, opt_state=state.tx.init(params))


def _jax_draws(state, step, shape):
    """The JAX step's draws, rebuilt as ``train/step.py`` makes them."""
    rng = jax.random.fold_in(state.rng, step)
    k_noise, k_t, k_cond, k_cfg, _ = jax.random.split(rng, 5)
    return {"noise": np.asarray(jax.random.normal(k_noise, shape)),
            "u": np.asarray(jax.random.uniform(k_t, (shape[0],))),
            "cond_noise": np.asarray(jax.random.normal(k_cond, shape)),
            "cfg_u": np.asarray(jax.random.uniform(k_cfg, (shape[0], 1, 1))),
            "layer_seeds": [0, 0]}


@pytest.mark.parametrize("accum,perceptual", [(1, False), (2, False),
                                               (1, True)])
def test_train_steps_match_jax(jax_flash, accum, perceptual):
    """Two whole steps (condition noise and CFG dropout on, warmup 1 so the
    second step moves the parameters) fed the JAX step's draws."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig

    from jatsr_torch.configs import LossConfig, TrainConfig

    kw = dict(batch_size=B, lr=1e-3, warmup_steps=1, cfg_dropout_prob=0.5,
              condition_noise_ratio=0.05, grad_accum_steps=accum)
    lkw = dict(use_latent_perceptual=perceptual)
    rng = np.random.default_rng(2)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    stats = _stats(rng)
    tcfg = _tiny(get_preset)
    dense = random_dense_params(tcfg, 3)

    jstate = _jax_state(JaxTrainConfig(**kw), dense, hr, lr)
    jstep = jax.jit(jax_train_step(JaxLossConfig(**lkw), JaxTrainConfig(**kw),
                                   JaxNormalizer(*stats)))
    state = create_train_state(DenseDiT(tcfg, dense, device="cpu"),
                               TrainConfig(**kw), 100, (hr, lr), device="cpu")
    step = make_train_step(LossConfig(**lkw), TrainConfig(**kw),
                           Normalizer(*stats, device="cpu"))
    for s in range(2):
        draws = _jax_draws(jstate, s, hr.shape)
        jstate, jm = jstep(jstate, hr, lr)
        state, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                        draws=draws)
        assert set(m) == set(jm)
        np.testing.assert_allclose(float(m["cond_noise_std"]),
                                   float(jm["cond_noise_std"]), rtol=1e-6)
        for k in set(jm) - {"cond_noise_std", "snr_db", "pred_mean"} \
                - ({"grad_norm"} if perceptual else set()):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2,
                                       err_msg=k)
        np.testing.assert_allclose(float(m["snr_db"]), float(jm["snr_db"]),
                                   atol=1e-2)
        np.testing.assert_allclose(float(m["pred_mean"]),
                                   float(jm["pred_mean"]), atol=1e-3)
    assert state.step == int(jstate.step) == 2
    if perceptual:
        return
    lr1 = 1e-3  # the second step's rate; the first one's is 0 (warmup)
    got, want, start = (_flat(t) for t in (
        dense_tree_from_module(state.model), jstate.params, dense))
    moved = 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr1 * 1.01, k
        assert d.mean() <= 0.02 * lr1, k
        moved = max(moved, float(np.abs(w - start[k]).max()))
    assert moved > 0.5 * lr1


def test_loss_gradients_match_jax():
    """The loss stack's gradient with respect to an identical fp32
    prediction (the FFTs' backward included)."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.losses import total_training_loss as jax_loss

    from jatsr_torch.configs import LossConfig
    from jatsr_torch.losses import total_training_loss

    rng = np.random.default_rng(8)
    p, t, c = (rng.standard_normal((B, T, C), dtype=np.float32)
               for _ in range(3))
    for kw in (dict(use_latent_perceptual=True),
               dict(reconstruction="charbonnier", use_latent_perceptual=True,
                    freq_loss_variant="buggy_v3mod1")):
        want = np.asarray(jax.grad(lambda x: jax_loss(
            x, t, c, JaxLossConfig(**kw))[0])(jnp.asarray(p)))
        tp = torch.from_numpy(p).requires_grad_()
        total_training_loss(tp, torch.from_numpy(t), torch.from_numpy(c),
                            LossConfig(**kw))[0].backward()
        np.testing.assert_allclose(tp.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_eval_step_matches_jax():
    """The deterministic model (the einsum attention) on uniform t."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig

    from jatsr_torch.configs import LossConfig, TrainConfig

    rng = np.random.default_rng(4)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    stats = _stats(rng)
    tcfg = _tiny(get_preset)
    dense = random_dense_params(tcfg, 5)
    lcfg = dict(reconstruction="charbonnier", use_latent_perceptual=True)
    jstate = _jax_state(JaxTrainConfig(), dense, hr, lr)
    key = jax.random.PRNGKey(9)
    want = jax_eval_step(JaxLossConfig(**lcfg), JaxNormalizer(*stats))(
        jstate, hr, lr, key)
    k_t, k_noise = jax.random.split(key)
    draws = {"t": np.asarray(jax.random.uniform(k_t, (B,))),
             "noise": np.asarray(jax.random.normal(k_noise, hr.shape))}
    state = create_train_state(DenseDiT(tcfg, dense, device="cpu"),
                               TrainConfig(), 100, (hr, lr), device="cpu")
    got = make_eval_step(LossConfig(**lcfg), Normalizer(*stats,
                                                        device="cpu"))(
        state, torch.from_numpy(hr), torch.from_numpy(lr), draws=draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("impl,kernel", [
    ("pallas", "gqa_attention"), ("pallas2", "gqa_attention_grouped"),
    ("flash", "gqa_attention_flash"), ("xla", None)])
def test_dense_dit_eval_forward_takes_the_jax_attention(impl, kernel,
                                                        monkeypatch):
    """The deterministic forward of the trainable DiT under each
    ``attention_impl`` against JAX ``DiT.apply`` (matmul_precision "bf16",
    split q/k/v): both reach the same serving kernel (the per-q-head, the
    per-kv-head or the split flash kernel; the einsum for "xla") on 45
    patches.  The outputs agree within 2e-2 x their max (measured 6.9e-3):
    bf16 products of the same weights, rounded where each framework rounds
    them."""
    from jatsr_tpu.ops import attention as jattn

    from torch_parity import Spy

    names = ("gqa_attention", "gqa_attention_grouped", "gqa_attention_flash")
    spies = [{n: Spy(monkeypatch, n, m) for n in names} for m in (jattn, None)]
    tcfg = _tiny(get_preset, attention_impl=impl)
    dense = random_dense_params(tcfg, 12)
    rng = np.random.default_rng(13)
    x, c = (rng.standard_normal((2, 45 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(JaxDiT(_tiny(jax_get_preset, attention_impl=impl)).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, dense)}, x, t, c))
    with torch.no_grad():
        got = DenseDiT(tcfg, dense, device="cpu")(*map(torch.from_numpy,
                                                       (x, t, c))).numpy()
    reached = [{n for n in names if s[n].calls} for s in spies]
    assert reached[0] == reached[1] == ({kernel} if kernel else set())
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, atol=2e-2 * scale)


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_remat_full_equals_none_with_dropout(attn):
    """Remat replays each block's forward in backward: with dropout 0.1 and
    drop-path on, its masks come from the block's seed, so the gradients
    are bit-equal to the run without remat."""
    def grads(policy):
        cfg = _tiny(get_preset, dropout=0.1, drop_path_rate=0.3,
                    remat_policy=policy, train_attention_impl=attn)
        model = DenseDiT(cfg, random_dense_params(cfg, 6), device="cpu")
        rng = np.random.default_rng(7)
        x, c = (torch.from_numpy(rng.standard_normal((2, 40, 1024),
                                                     dtype=np.float32))
                for _ in range(2))
        out = model(x, torch.tensor([0.2, 0.6]), c, deterministic=False,
                    layer_seeds=[5, -6])
        (out ** 2).mean().backward()
        return [p.grad for p in model.parameters()], out.detach()

    (g_full, o_full), (g_none, o_none) = grads("full"), grads("none")
    assert torch.equal(o_full, o_none)
    for a, b in zip(g_full, g_none):
        assert torch.equal(a, b)
    # The masks are live: another seed moves the output.
    cfg = _tiny(get_preset, dropout=0.1, train_attention_impl=attn)
    model = DenseDiT(cfg, random_dense_params(cfg, 6), device="cpu")
    x = torch.ones(1, 8, 1024)
    with torch.no_grad():
        a = model(x, torch.tensor([0.5]), x, False, [1, 2])
        b = model(x, torch.tensor([0.5]), x, False, [1, 3])
        c = model(x, torch.tensor([0.5]), x, False, [1, 2])
    assert not torch.equal(a, b) and torch.equal(a, c)


def test_init_dense_params_draws_as_flax():
    cfg = _tiny(get_preset)
    tree = init_dense_params(cfg, torch.Generator().manual_seed(0))
    x = jnp.zeros((1, 8, 1024))
    shapes = jax.eval_shape(lambda: JaxDiT(_tiny(jax_get_preset)).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, jnp.zeros(1), x)["params"])
    flat = _flat(tree)
    assert {k: v.shape for k, v in flat.items()} == {
        jax.tree_util.keystr(k): v.shape
        for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    for k, v in flat.items():
        if "adaln" in k or "final_proj" in k or "bias" in k:
            assert not v.any(), k
        else:
            std = v.shape[-2] ** -0.5
            assert abs(v.std() / std - 1) < 0.1, k
            assert np.abs(v).max() <= 2 * std / 0.8796 + 1e-6, k
    model = DenseDiT(cfg, tree, device="cpu")
    back = _flat(dense_tree_from_module(model))
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("knob", [dict(param_dtype="float16"),
                                  dict(matmul_precision="int8_static")])
def test_training_knobs_of_later_slices_raise(knob):
    """A knob of a branch the port lacks raises: one that every path reads
    (``matmul_precision="int8_static"``, a parameter dtype other than fp32
    and bf16) already where the model is built.  Every remat policy trains
    (``tests/test_torch_remat.py``), and so do bf16 scores
    (``tests/test_torch_dtypes.py``), fp32 compute and bf16 parameters
    (``tests/test_torch_train_f32.py``) and dynamic int8
    (``tests/test_torch_int8_train.py``)."""
    x = torch.zeros(1, 8, 1024)
    with pytest.raises(NotImplementedError, match="later slice"):
        DenseDiT(_tiny(get_preset, **knob), device="cpu")(
            x, torch.zeros(1), x, deterministic=False, layer_seeds=[0, 1])


@pytest.mark.parametrize("knob", [dict(remat_policy="dots"),
                                  dict(remat_policy="mlp"),
                                  dict(scores_dtype="bfloat16")])
def test_training_only_knobs_do_not_stop_serving(knob):
    """The deterministic (serving) forward reads none of these: the model
    builds and serves; with bf16 scores its einsum attention stores them in
    bf16, as the JAX model's deterministic einsum does."""
    cfg = _tiny(get_preset, attention_impl="xla", **knob)
    tree = random_dense_params(cfg, 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 32, 1024), dtype=np.float32))
    with torch.no_grad():
        got = DenseDiT(cfg, tree, device="cpu")(x, torch.tensor([0.4]), x)
    want = np.asarray(JaxDiT(_tiny(jax_get_preset, attention_impl="xla",
                                   **knob)).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
        x.numpy(), np.array([0.4], np.float32), x.numpy()))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * scale)
