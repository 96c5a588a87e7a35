"""Dynamic int8 in training (``matmul_precision="int8"`` where the model
trains) against the JAX package on the CPU.

JAX differentiates its ``int8_dot_general`` (``jatsr_tpu/ops/quant.py``)
through the XLA branch of ``w8a8_dot`` at every ``int8_impl`` off a TPU.
The codes carry no cotangent (``round``, an int8 cast, an int32 product),
so the weight and the activation get gradients only through their
quantisation scales; the port's ``_Int8DotGeneral`` takes the same
cotangents in torch ops.

Tolerances:

- the cotangents of one product on identical inputs: the same nonzero
  positions (a weight column with tied maxima splits its cotangent, a zero
  row gets none); values within one bf16 ulp of the largest (2^-8 of the
  max |cotangent|) at bf16 and 1e-5 of it at fp32, where the fp32 sums run
  in another order;
- ``DenseDiT`` train steps fed the JAX step's draws: the bf16 bounds of
  ``tests/test_torch_train_step.py`` (metrics rtol 1e-2, gradients
  normalised by their max atol 3e-2), the gradients on all but a few
  elements of each leaf (at most 16, and 2 % of it).  A product's
  activation cotangent lands on its row maximum alone, and the weight's on
  its column maximum, so where the two forwards (equal to within bf16
  rounding) take a row's maximum at another element of a near tie, the
  cotangent of that row moves whole to another position upstream: one
  step of the tiny model moves 1-12 elements of a leaf past the bound
  (up to 0.26 of the leaf's max, on mlp_in, whose cotangent is mlp_out's
  row maxima through the GELU);
- the "dots" remat policy and the others: gradients bit-equal to "none",
  and the int8 products a backward replays held to the JAX gradient's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops import attention_train as jat
from jatsr_tpu.ops.quant import int8_dot_general as jax_int8_dot_general
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import (dense_tree_from_module,
                                         dense_tree_from_named,
                                         random_dense_params)
from jatsr_torch.ops.quant import INT8_IMPLS, int8_dot_general

INT8 = dict(matmul_precision="int8")


def _inputs(rng):
    """``x [2, 20, 128]`` with an all-zero row and a row whose max is taken
    twice (+3 and -3), a weight ``[128, 128]`` whose column 7 has two tied
    maxima (+0.2 and -0.2), and a cotangent."""
    x = rng.standard_normal((2, 20, 128)).astype(np.float32)
    x[0, 3] = 0.0
    x[1, 2, 4], x[1, 2, 8] = 3.0, -3.0
    w = 0.05 * rng.standard_normal((128, 128)).astype(np.float32)
    w[5, 7], w[9, 7] = 0.2, -0.2
    g = rng.standard_normal((2, 20, 128)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", INT8_IMPLS)
def test_cotangents_match_jax_grad(impl, dtype):
    x, w, g = _inputs(np.random.default_rng(0))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    dn = (((2,), (0,)), ((), ()))
    out, vjp = jax.vjp(lambda a, b: jax_int8_dot_general(a, b, dn, impl=impl),
                       jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_x, want_w = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    got = int8_dot_general(tx, tw, impl)
    got.backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out, np.float32))
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-5
    for name, a, b in (("x", tx.grad, want_x), ("kernel", tw.grad, want_w)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_array_equal(a != 0, b != 0, err_msg=name)
        np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max(),
                                   rtol=0, err_msg=name)
    assert (tx.grad[0, 3] == 0).all()
    assert tw.grad[5, 7] == -tw.grad[9, 7] != 0  # the tie split in two


def test_forward_only_saves_nothing():
    """Without a gradient to take the product is the serving one: no
    autograd node."""
    x, w, _ = _inputs(np.random.default_rng(1))
    out = int8_dot_general(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16())
    assert out.grad_fn is None


def _tiny(getter, **kw):
    return dataclasses.replace(getter("tiny").model, **INT8, **kw)


def test_train_step_matches_jax(monkeypatch):
    """Two whole steps of the tiny DenseDiT at ``matmul_precision="int8"``
    (B10's plain versions; JAX's B10 in interpret mode), condition noise
    and CFG dropout on, warmup 1, fed the JAX step's draws: the metrics of
    both, the gradients of the first (its first moments; its rate is 0),
    and every leaf moved by the second."""
    import test_torch_train_step as ts
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig
    from jatsr_tpu.train import create_train_state as jax_create_state
    from jatsr_tpu.train import make_train_step as jax_train_step
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer

    from jatsr_torch.configs import LossConfig, TrainConfig
    from jatsr_torch.train import create_train_state, make_train_step
    from jatsr_torch.train.step import Normalizer

    monkeypatch.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)
    kw = dict(batch_size=ts.B, lr=1e-3, warmup_steps=1, cfg_dropout_prob=0.5,
              condition_noise_ratio=0.05)
    lkw = dict(use_latent_perceptual=False)
    rng = np.random.default_rng(2)
    hr, lr = (rng.standard_normal((ts.B, ts.T, ts.C), dtype=np.float32)
              for _ in range(2))
    stats = ts._stats(rng)
    tcfg = _tiny(get_preset)
    dense = random_dense_params(tcfg, 3)
    jstate = jax_create_state(JaxDiT(_tiny(jax_get_preset)),
                              JaxTrainConfig(**kw), total_steps=100,
                              sample_batch=(hr, lr))
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jax.jit(jax_train_step(JaxLossConfig(**lkw), JaxTrainConfig(**kw),
                                   JaxNormalizer(*stats)))
    state = create_train_state(DenseDiT(tcfg, dense, device="cpu"),
                               TrainConfig(**kw), 100, (hr, lr), device="cpu")
    step = make_train_step(LossConfig(**lkw), TrainConfig(**kw),
                           Normalizer(*stats, device="cpu"))
    for s in range(2):
        draws = ts._jax_draws(jstate, s, hr.shape)
        jstate, jm = jstep(jstate, hr, lr)
        state, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                        draws=draws)
        for k in set(jm) - {"cond_noise_std", "snr_db", "pred_mean"}:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2,
                                       err_msg=k)
        if s == 0:  # lr 0: the first moments are (1 - b1) times the grads
            mu = dense_tree_from_named(state.state_dict()["opt"]["mu"], tcfg)
            _assert_int8_grads(ts._flat(mu), ts._flat(_jax_mu(
                jstate.opt_state)))
    got, start = (ts._flat(t) for t in (dense_tree_from_module(state.model),
                                        dense))
    assert all(np.abs(got[k] - start[k]).max() > 0 for k in start)


def _assert_int8_grads(got, want):
    """The bf16 step's bound (normalised by the leaf's max, atol 3e-2) on
    all but the few elements that a row maximum taken at another element
    feeds: at most 16 a leaf and 2 % of it."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        off = np.abs(got[k] - w) / scale > 3e-2
        assert off.sum() <= min(16, 0.02 * off.size), (k, int(off.sum()))


def _jax_mu(opt_state):
    """The first moments of optax's Adam state in a JAX train state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


class _IntMmCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten._int_mm.default
        return func(*args, **(kwargs or {}))


def _jax_int8_dots(policy):
    """int32 ``dot_general`` s in the jaxpr of the JAX model's gradient
    (the scanned block's body appears once)."""
    cfg = _tiny(jax_get_preset, remat_policy=policy)
    x = jnp.ones((2, 40, 1024))
    params = random_dense_params(_tiny(get_preset), 0)

    def loss(p):
        out = JaxDiT(cfg).apply({"params": p}, x, jnp.array([0.2, 0.6]), x,
                                deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out ** 2)

    jaxpr = str(jax.make_jaxpr(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, params)))
    return sum(1 for line in jaxpr.splitlines()
               if "dot_general" in line and ":i32[" in line.split("=")[0])


_NONE = {}


def _port_run(policy):
    """Gradients and the int8 products of the backward of one training
    forward of the tiny DenseDiT at int8 (dropout and drop-path on)."""
    cfg = _tiny(get_preset, remat_policy=policy, dropout=0.1,
                drop_path_rate=0.3)
    model = DenseDiT(cfg, random_dense_params(cfg, 0), device="cpu")
    rng = np.random.default_rng(7)
    x, c = (torch.from_numpy(rng.standard_normal((2, 40, 1024),
                                                 dtype=np.float32))
            for _ in range(2))
    out = model(x, torch.tensor([0.2, 0.6]), c, deterministic=False,
                layer_seeds=[5, -6])
    count = _IntMmCount()
    with count:
        (out ** 2).mean().backward()
    return [p.grad for p in model.parameters()], count.n


@pytest.mark.parametrize("policy", ["full", "dots", "attn_out", "mlp",
                                    "none"])
def test_remat_replays_as_in_jax(policy):
    """Each policy's gradients are bit-equal to "none".  The backward of
    each int8 product recomputes its int32 product once (the Function keeps
    no ``acc``), so the port's backward runs the model's 2 + 6 depth int8
    products once more than JAX's; beyond those, it replays a block's
    products as JAX's gradient does: none under "none" and "dots" (which
    keeps the plain path's int32 products, as JAX's
    ``dots_with_no_batch_dims_saveable`` keeps its s32 ``dot_general``),
    all six under "full" and "attn_out".  Under "mlp" the port keeps
    mlp_in's output between its segments and replays five; JAX replays
    mlp_in's product too, for the int32 product its scales' cotangents
    need, which the port's backward recomputes instead."""
    if "none" not in _NONE:
        _NONE["none"] = _port_run("none")
    g, n = _NONE["none"] if policy == "none" else _port_run(policy)
    for a, b in zip(g, _NONE["none"][0]):
        assert torch.equal(a, b)
    depth = get_preset("tiny").model.depth
    # JAX's jaxpr holds the scanned block's body once: its forward has
    # 2 + 6 int8 products, and each replay is a block's.
    jax_replays = _jax_int8_dots(policy) - (2 + 6)
    port_replays = (n - (2 + 6 * depth)) / depth
    assert jax_replays == {"none": 0, "dots": 0, "full": 6, "attn_out": 6,
                           "mlp": 6}[policy]
    assert port_replays == jax_replays - (policy == "mlp")
