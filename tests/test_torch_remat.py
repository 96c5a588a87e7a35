"""The trainable DiT's remat policies ("full", "dots", "attn_out", "mlp")
against "none" and against the JAX model.

- Each policy's gradients are bit-equal to "none" on the CPU with dropout
  and drop-path on: the replayed segments draw their masks again from the
  block generator's state where the segment began.
- Each is within the step tolerance of the JAX model's gradients under the
  same policy (dropout 0: the frameworks draw other masks), grads
  normalised by their max atol 3e-2 (``tests/test_torch_train_step.py``).
- B10's forward runs twice a block under every policy but "none", as in
  the JAX model, whose gradient replays the kernel's forward under every
  remat policy (its softmax statistics are a residual of the kernel's
  custom VJP with no checkpoint name): the port's count of the plain
  forward per block equals the jaxpr's ``pallas_call`` count less the
  backward's one.
- What each policy keeps: the projections (aten ``mm``) replayed in
  backward, a block: all seven under "full", none under "dots", all but
  ``out_proj`` (its output ends the first segment) and ``adaln`` (it runs
  outside the segments) under "attn_out", and under "mlp" also not
  ``mlp_in``, whose output is kept.
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
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import (dense_tree_from_module,
                                         random_dense_params)
from jatsr_torch.ops import attention_train as at

POLICIES = ["full", "dots", "attn_out", "mlp"]


def _cfg(getter, **kw):
    return dataclasses.replace(getter("tiny").model, **kw)


class _MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _run(policy, attn="flash", dropout=0.1, drop_path=0.3, monkeypatch=None):
    """Gradients, output, B10 plain forward calls and the mm calls of the
    backward of one training forward of the tiny DiT."""
    cfg = _cfg(get_preset, dropout=dropout, drop_path_rate=drop_path,
               remat_policy=policy, train_attention_impl=attn)
    model = DenseDiT(cfg, random_dense_params(cfg, 6), device="cpu")
    rng = np.random.default_rng(7)
    x, c = (torch.from_numpy(rng.standard_normal((2, 40, 1024),
                                                 dtype=np.float32))
            for _ in range(2))
    calls = []
    if monkeypatch is not None:
        plain = at.attention_train_fwd_plain
        monkeypatch.setattr(at, "attention_train_fwd_plain",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = model(x, torch.tensor([0.2, 0.6]), c, deterministic=False,
                layer_seeds=[5, -6])
    mm = _MatmulCount()
    with mm:
        (out ** 2).mean().backward()
    return ([p.grad for p in model.parameters()], out.detach(), len(calls),
            mm.n)


_NONE = {}


@pytest.mark.parametrize("attn", ["flash", "xla"])
@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_bit_equal_to_no_remat(policy, attn):
    if attn not in _NONE:
        _NONE[attn] = _run("none", attn)
    g_none, o_none, _, _ = _NONE[attn]
    g, o, _, _ = _run(policy, attn)
    assert torch.equal(o, o_none)
    for a, b in zip(g, g_none):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES + ["none"])
def test_gradients_match_jax_under_the_same_policy(policy, monkeypatch):
    """45 patches (B10 pads to 48 and masks); dropout and drop-path 0."""
    monkeypatch.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)
    kw = dict(remat_policy=policy)
    cfg = _cfg(get_preset, **kw)
    dense = random_dense_params(cfg, 0)
    rng = np.random.default_rng(1)
    x, c = (rng.standard_normal((2, 45 * 4, 1024), dtype=np.float32)
            for _ in range(2))
    t = np.array([0.3, 0.8], np.float32)

    def jloss(p):
        out = JaxDiT(_cfg(jax_get_preset, **kw)).apply(
            {"params": p}, x, t, c, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.mean(out ** 2)

    g_j = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, dense))
    model = DenseDiT(cfg, dense, device="cpu")
    out = model(*map(torch.from_numpy, (x, t, c)), deterministic=False,
                layer_seeds=[11, -12])
    (out ** 2).mean().backward()
    got = dense_tree_from_module(_GradView(model))
    flat_j = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
              for k, v in jax.tree_util.tree_leaves_with_path(g_j)}
    flat_t = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_t.keys() == flat_j.keys()
    for k, w in flat_j.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(flat_t[k] / scale, w / scale, atol=3e-2,
                                   err_msg=k)


class _GradView:
    def __init__(self, model):
        self.cfg = model.cfg
        self._m = model

    def named_parameters(self):
        return [(k, v.grad) for k, v in self._m.named_parameters()]


def _jax_pallas_calls(policy):
    """``pallas_call`` s in the jaxpr of the JAX model's gradient (the
    scanned block's body appears once)."""
    cfg = _cfg(jax_get_preset, dropout=0.1, remat_policy=policy)
    x = jnp.ones((2, 40, 1024))
    params = random_dense_params(_cfg(get_preset), 0)

    def loss(p):
        out = JaxDiT(cfg).apply({"params": p}, x, jnp.array([0.2, 0.6]), x,
                                deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out ** 2)

    return str(jax.make_jaxpr(jax.grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, params))).count("pallas_call")


@pytest.mark.parametrize("policy", POLICIES + ["none"])
def test_b10_forward_replays_as_in_jax(policy, monkeypatch):
    monkeypatch.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)
    jax_calls = _jax_pallas_calls(policy)
    _, _, fwd_calls, _ = _run(policy, monkeypatch=monkeypatch)
    depth = get_preset("tiny").model.depth
    assert fwd_calls == depth * (jax_calls - 1)
    assert fwd_calls == depth * (1 if policy == "none" else 2)


def test_what_each_policy_keeps():
    depth = get_preset("tiny").model.depth
    base = _run("none")[3]
    replayed = {p: (_run(p)[3] - base) / depth for p in POLICIES}
    assert replayed == {"full": 7, "dots": 0, "attn_out": 5, "mlp": 4}
