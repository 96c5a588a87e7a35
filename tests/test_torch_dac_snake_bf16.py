"""The DAC kernels' bf16 snake (``set_snake_compute_dtype("bfloat16")``,
``bench.py --snake-bf16``) against the JAX package's, on the CPU.

In that mode the JAX kernels (B6-B9) compute snake as a chain of bf16 ops:
x and a cast to bf16, then a x, sin, the square, a + 1e-9, the reciprocal,
the product and the sum, each rounded to bf16.  The port's plain versions
(what its wrappers run on CPU tensors) follow the same chain
(``ops/dac_kernels.py:snake_b16``); its CUDA kernels round at the same
points (``csrc/snake.cuh``'s ``*_b16`` functions).  Both sides read the
mode at call time here; the JAX kernels capture it at trace time, so the
JAX caches are cleared around each switch.

Tolerances: the snake alone, bit for bit.  XLA on the CPU may skip a bf16
round trip inside a fusion (excess precision); a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` holds the jitted JAX
snake bit-equal to the port's as well.  The kernels: the fp32 mode's
bounds (``tests/test_torch_dac_kernels.py``): 1e-3 x max |JAX| for B7 and
B8, 4e-3 for B9 and B6 (measured in this mode: up to 3.0e-7 for B7 and
B8, 6.5e-4 for B9, 2.3e-3 for B6).
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import dac_kernels as jdk
from jatsr_torch.ops import dac_kernels as dk

from test_torch_dac_kernels import (REL, REL_UNIT, _assert_rel, _both,
                                    _tr_inputs, _unit_inputs)


@pytest.fixture
def bf16_snake():
    """Both packages' snakes in bf16 for the test, fp32 after."""
    jdk.set_snake_compute_dtype("bfloat16")
    dk.set_snake_compute_dtype("bfloat16")
    jax.clear_caches()
    yield
    jdk.set_snake_compute_dtype("float32")
    dk.set_snake_compute_dtype("float32")
    jax.clear_caches()


def _snake_inputs(seed, n=8192):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    a = (np.abs(rng.standard_normal(n)) + 0.05).astype(np.float32)
    a[:4] = (1e-10, 3e-9, 0.0, 2e-7)  # near the 1e-9 of a + 1e-9
    return x, a


def test_snake_b16_is_the_jax_chain_bit_for_bit(bf16_snake):
    x, a = _snake_inputs(0)
    want = np.asarray(jax.jit(jdk._snake_b16)(jnp.asarray(x), jnp.asarray(a))
                      .astype(jnp.float32))
    got = dk.snake_b16(torch.from_numpy(x), torch.from_numpy(a))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    dk.set_snake_compute_dtype("float32")  # the mode is read at each call
    fp32 = dk.snake_b16(torch.from_numpy(x), torch.from_numpy(a))
    assert not torch.equal(fp32, got)


_STRICT = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
import torch
sys.path.insert(0, {tests!r})
from test_torch_dac_snake_bf16 import _snake_inputs
from jatsr_tpu.ops import dac_kernels as jdk
from jatsr_torch.ops import dac_kernels as dk
jax.config.update("jax_platforms", "cpu")
jdk.set_snake_compute_dtype("bfloat16")
dk.set_snake_compute_dtype("bfloat16")
x, a = _snake_inputs(1)
want = np.asarray(jax.jit(jdk._snake_b16)(jnp.asarray(x), jnp.asarray(a))
                  .astype(jnp.float32))
got = dk.snake_b16(torch.from_numpy(x), torch.from_numpy(a)).float().numpy()
print("EQUAL" if np.array_equal(got, want) else "DIFFER",
      int((got != want).sum()))
"""


def test_snake_b16_bit_for_bit_without_excess_precision():
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    tests = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _STRICT.format(tests=tests)],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=os.path.dirname(tests))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["EQUAL", "0"], out.stdout


@pytest.mark.parametrize("C,T,dilation", [(128, 3200, 1), (96, 2000, 9)])
def test_res_unit_matches_jax(bf16_snake, C, T, dilation):
    j, t = _both(_unit_inputs(C + dilation, T, C))
    want = jdk.res_unit_fused(*j, dilation=dilation, interpret=True)
    got = dk.res_unit_fused(*t, dilation=dilation)
    _assert_rel(got, want, REL_UNIT)


def test_res_stage_matches_jax(bf16_snake):
    j, t = _both(_unit_inputs(3, 4100, 128, units=3))
    want = jdk.res_stage_fused(*j, interpret=True)
    got = dk.res_stage_fused(*t)
    _assert_rel(got, want, REL_UNIT)


@pytest.mark.parametrize("ci,co,s,T", [(192, 96, 2, 151), (384, 192, 4, 130),
                                       (768, 384, 8, 65)])
def test_snake_conv_transpose_matches_jax(bf16_snake, monkeypatch, ci, co, s,
                                          T):
    table = {192: 64, 384: 64, 768: 64}
    monkeypatch.setattr(jdk, "_TBLK_TR", table)
    monkeypatch.setattr(dk, "_TBLK_TR", dict(table))
    kw = dict(stride=s, padding=math.ceil(s / 2), output_padding=s % 2)
    j, t = _both(_tr_inputs(ci + T, ci, co, s, T))
    want = jdk.snake_conv_transpose_fused(*j, **kw, interpret=True)
    got = dk.snake_conv_transpose_fused(*t, **kw)
    _assert_rel(got, want, REL)


def test_snake_conv_transpose_streamed_matches_jax(bf16_snake, monkeypatch):
    ci, co, s, T = 1536, 768, 8, 40
    monkeypatch.setattr(jdk, "_TBLK_TR_STREAM", 32)
    monkeypatch.setattr(dk, "_TBLK_TR_STREAM", 32)
    kw = dict(stride=s, padding=math.ceil(s / 2), output_padding=s % 2)
    j, t = _both(_tr_inputs(ci, ci, co, s, T))
    want = jdk.snake_conv_transpose_fused(*j, **kw, interpret=True)
    got = dk.snake_conv_transpose_streamed(*t, **kw)
    _assert_rel(got, want, REL)


def test_set_snake_compute_dtype_names_the_two_modes():
    with pytest.raises(ValueError):
        dk.set_snake_compute_dtype("float16")
    assert dk.SNAKE_COMPUTE_DTYPE == "float32"
