"""Shared set-up for the port's parity tests: one narrow int8_static DiT
built from the same seeded weights on both sides.

The dense weights come from the port's seeded initializer (numpy), with
non-zero ``adaln`` and ``final_proj`` (the JAX init zeroes them, which
would make the DiT the identity and every comparison vacuous).  Each side
quantizes them with its own ``quantize_params_static``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops.quant import quantize_params_static as jax_quantize
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DiT
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops.quant import quantize_params_static

C = 64  # latent channels: patch width 4 * 2 * 64 = 512, a multiple of 128


def narrow_cfg(preset_getter, norm="layer", **knobs):
    """hidden 128, depth 2, 4/2 heads, bottleneck 128 (so the patch embed
    takes the fused kernel), on the flash / half-MLP int8 serving branch;
    ``knobs`` (e.g. ``fused_prologue=True, align_n=True``) on top."""
    return dataclasses.replace(
        preset_getter("tiny").model, bottleneck_dim=128, input_channels=C,
        cond_channels=C, norm=norm, matmul_precision="int8_static",
        **{"attention_impl": "flash", "fused_qkv": True, "fused_mlp": True,
           **knobs})


def build_pair(norm="layer", seed=0, **knobs):
    """(jax_model, jax_static_params, torch_model, dense_numpy_params)."""
    jcfg = narrow_cfg(jax_get_preset, norm, **knobs)
    tcfg = narrow_cfg(get_preset, norm, **knobs)
    dense = random_dense_params(tcfg, seed)
    jmodel = JaxDiT(jcfg)
    x = jnp.zeros((1, 8, C), jnp.float32)
    shape = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                            jnp.zeros((1,)), x)["params"])
    jparams = jax_quantize(jax.tree_util.tree_map(jnp.asarray, dense), shape)
    tmodel = DiT(tcfg, quantize_params_static(dense, tcfg), device="cpu")
    return jmodel, jparams, tmodel, dense


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Spy:
    """Wraps a function of ``module`` (default ``jatsr_torch.models.dit``)
    and records calls."""

    def __init__(self, monkeypatch, name, module=None):
        import jatsr_torch.models.dit as tdit

        module = module or tdit
        self.fn, self.calls = getattr(module, name), []
        monkeypatch.setattr(module, name, self)

    def __call__(self, *a, **kw):
        self.calls.append((a, kw))
        return self.fn(*a, **kw)
