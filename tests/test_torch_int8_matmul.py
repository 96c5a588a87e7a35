"""The port's int8 serving products against the JAX package.

``int8_dense_gelu_quant``: the JAX kernel in interpret mode against the
port's plain PyTorch version.  The int8 product is exact on both sides, so
the codes differ only where the two frameworks' tanh/exp/erf differ in the
last fp32 bit and push a value across a rounding boundary: at most 0.5% of
the codes, each by exactly +-1.  The row scales are max|g| * (1/127) and
agree to rtol 1e-6.

``w8a8_dot``: exact int32 accumulation at K=5120 (where an fp32 sum is not
exact), so the outputs are bit-equal.

``int8_matmul`` (the s8 product on a pre-quantised A): the JAX kernel in
interpret mode, the port's plain version and ``w8a8_dot(impl="xla")`` use
only an exact int32 product and the same two fp32 multiplies: bit-equal,
in bf16 and fp32 output, and ``w8a8_dot(impl="pallas")`` with them, also
on rows where the floored and unfloored scales differ.

``int8_mlp`` (the whole MLP): both sides round at the same points, so the
outputs are equal but where the two frameworks' tanh/exp/erf differ in the
last fp32 bit and move a bf16 y or g, or a code, by one.  Bound: at most
0.1 % of the outputs differ, each within 0.02 absolute plus 0.02 relative
(the JAX package's own bound against the "half" path is 0.05, with 99 %
within 0.02); measured: one output in 6144 at 7.8e-3 (erf, two slabs),
none or a last-bit difference elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import int8_matmul as jax_mm
from jatsr_tpu.ops.int8_matmul import int8_dense_gelu_quant as jax_dgq
from jatsr_tpu.ops.quant import w8a8_dot as jax_w8a8_dot
from jatsr_torch.ops.int8_matmul import (_pick_slabs, int8_dense_gelu_quant,
                                         int8_matmul, int8_mlp,
                                         int8_quantize_rows, quantize_rows)
from jatsr_torch.ops.quant import QuantDense, w8a8_dot


def _dgq_inputs(seed, M=100, K=256, N=512):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / (127 * np.sqrt(K))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((1, N))).astype(np.float32)
    return a, w_q, w_s, b


def assert_codes_close(got_q, got_s, want_q, want_s):
    diff = got_q.astype(np.int32) - want_q.astype(np.int32)
    assert np.abs(diff).max() <= 1, np.abs(diff).max()
    assert (diff != 0).mean() <= 0.005, (diff != 0).mean()
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)


@pytest.mark.parametrize("gelu_impl", ["tanh", "erf"])
@pytest.mark.parametrize("fast_epilogue", [True, False])
def test_dense_gelu_quant_matches_jax(gelu_impl, fast_epilogue):
    a, w_q, w_s, b = _dgq_inputs(seed=1)
    want_q, want_s = jax_dgq(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w_q),
                             jnp.asarray(w_s), jnp.asarray(b), interpret=True,
                             gelu_impl=gelu_impl, fast_epilogue=fast_epilogue)
    got_q, got_s = int8_dense_gelu_quant(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(w_q),
        torch.from_numpy(w_s), torch.from_numpy(b), gelu_impl=gelu_impl,
        fast_epilogue=fast_epilogue)
    assert got_q.dtype == torch.int8 and got_q.shape == (100, 512)
    assert got_s.dtype == torch.float32 and got_s.shape == (100, 1)
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


def test_dense_gelu_quant_sigmoid_matches_jax():
    a, w_q, w_s, b = _dgq_inputs(seed=2)
    want_q, want_s = jax_dgq(jnp.asarray(a, jnp.bfloat16), jnp.asarray(w_q),
                             jnp.asarray(w_s), jnp.asarray(b), interpret=True,
                             gelu_impl="sigmoid")
    got_q, got_s = int8_dense_gelu_quant(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(w_q),
        torch.from_numpy(w_s), torch.from_numpy(b), gelu_impl="sigmoid")
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dot_bit_exact_at_k5120(dtype):
    rng = np.random.default_rng(7)
    M, K, N = 24, 5120, 256
    x = rng.standard_normal((2, M // 2, K), dtype=np.float32)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / 127).astype(np.float32)
    want = jax_w8a8_dot(jnp.asarray(x, dtype), jnp.asarray(w_q),
                        jnp.asarray(w_s))
    got = w8a8_dot(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(w_q), torch.from_numpy(w_s))
    assert got.shape == (2, M // 2, N) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quant_dense_adds_bias_in_output_dtype():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 5, 128), dtype=np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, (128, 64), dtype=np.int8))
    w_s = torch.full((1, 64), 1.0 / (127 * 128 ** 0.5))
    bias = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    out = QuantDense(w_q, w_s, bias)(x)
    want = w8a8_dot(x.bfloat16(), w_q, w_s) + bias.bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_dense_gelu_quant_rejects_unaligned_shapes():
    a, w_q, w_s, b = _dgq_inputs(seed=3, N=512)
    with pytest.raises(ValueError):
        int8_dense_gelu_quant(torch.from_numpy(a[:, :200]).bfloat16(),
                              torch.from_numpy(w_q[:200]),
                              torch.from_numpy(w_s), torch.from_numpy(b))
    with pytest.raises(ValueError):
        int8_dense_gelu_quant(torch.from_numpy(a).bfloat16(),
                              torch.from_numpy(w_q), torch.from_numpy(w_s),
                              torch.from_numpy(b), gelu_impl="relu")


@pytest.mark.parametrize("M,K,N", [(64, 128, 256), (100, 256, 384)])
def test_int8_matmul_bit_equal_to_jax_and_xla(M, K, N):
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.standard_normal((M, K), dtype=np.float32),
                    jnp.bfloat16)
    a_q, a_s = jax_mm.quantize_rows(a)
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / (127 * np.sqrt(K))).astype(
        np.float32)
    want = jax_mm.int8_matmul(a_q, a_s, jnp.asarray(w_q), jnp.asarray(w_s),
                              interpret=True)
    got = int8_matmul(torch.from_numpy(np.array(a_q)),
                      torch.from_numpy(np.array(a_s)),
                      torch.from_numpy(w_q), torch.from_numpy(w_s))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    x = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    for impl in ("xla", "pallas"):
        torch.testing.assert_close(
            w8a8_dot(x, torch.from_numpy(w_q), torch.from_numpy(w_s),
                     impl=impl), got, atol=0, rtol=0)


def _rows_below_the_floor(seed, M, K, N):
    """Seeded lhs ``[M, K]`` with row 3 all zero and row 5 scaled so that
    max|a| / 127 is below 1e-12 (the floored and unfloored scales differ
    there), an int8 kernel and its column scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), dtype=np.float32)
    x[3] = 0.0
    x[5] *= 1e-12
    w_q = rng.integers(-127, 128, (K, N), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, N)) / (127 * np.sqrt(K))).astype(
        np.float32)
    return x, w_q, w_s


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8a8_dot_pallas_bit_equal_to_jax_below_the_scale_floor(dtype):
    """``w8a8_dot(impl="pallas")`` against the JAX ``w8a8_dot`` on the same
    input (an all-zero row, a row below the scale floor), and the port's
    ``int8_matmul`` on the JAX quantiser's codes against the JAX kernel in
    interpret mode, in the lhs's dtype: bit-equal.  The port's quantiser
    (the card's row-quant launch's plain version) gives the JAX codes and
    unfloored scales."""
    x, w_q, w_s = _rows_below_the_floor(13, 40, 256, 384)
    a = jnp.asarray(x, dtype)
    want = np.asarray(jax_w8a8_dot(a, jnp.asarray(w_q), jnp.asarray(w_s),
                                   impl="pallas"), np.float32)
    t = torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype))
    w_qt, w_st = torch.from_numpy(w_q), torch.from_numpy(w_s)
    got = w8a8_dot(t, w_qt, w_st, impl="pallas", w_t=w_qt.t().contiguous())
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert np.abs(want[5]).max() > 0
    a_s = (jnp.max(jnp.abs(a), axis=-1, keepdims=True).astype(jnp.float32)
           * jax_mm._INV127)
    a_q = jnp.round(a.astype(jnp.float32) / jnp.maximum(a_s, 1e-12)).astype(
        jnp.int8)
    assert float(a_s[5, 0]) < 1e-12
    q, s = int8_quantize_rows(t)
    np.testing.assert_array_equal(q.numpy(), np.asarray(a_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(a_s))
    want = jax_mm.int8_matmul(a_q, a_s, jnp.asarray(w_q), jnp.asarray(w_s),
                              out_dtype=getattr(jnp, dtype), interpret=True)
    got = int8_matmul(q, s, w_qt, w_st, out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_matmul_fp32_plain_matches_jax_kernel():
    """B14's fp32 output mode: the plain version against the JAX
    ``int8_matmul(..., out_dtype=float32, interpret=True)`` on the JAX
    quantiser's codes (a zero row, a row below the floor), bit for bit."""
    x, w_q, w_s = _rows_below_the_floor(14, 64, 128, 256)
    a_q, a_s = jax_mm.quantize_rows(jnp.asarray(x, jnp.bfloat16))
    want = jax_mm.int8_matmul(a_q, a_s, jnp.asarray(w_q), jnp.asarray(w_s),
                              out_dtype=jnp.float32, interpret=True)
    w_qt = torch.from_numpy(w_q)
    got = int8_matmul(torch.from_numpy(np.array(a_q)),
                      torch.from_numpy(np.array(a_s)), w_qt,
                      torch.from_numpy(w_s), out_dtype=torch.float32,
                      w_t=w_qt.t().contiguous())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_checks_its_kmajor_copy_on_the_cpu():
    """``w_t`` is checked before the device branch: on the CPU a ``w_t``
    of the wrong shape, dtype or layout raises ``ValueError`` (the plain
    version reads ``w_q``); on the CPU none is needed.  The card's K only
    needs TMA's 16-byte rows."""
    x, w_q, w_s = _rows_below_the_floor(15, 40, 128, 256)
    a_q, a_s = quantize_rows(torch.from_numpy(x).bfloat16())
    w_qt, w_st = torch.from_numpy(w_q), torch.from_numpy(w_s)
    n0 = int8_matmul.launches
    want = int8_matmul(a_q, a_s, w_qt, w_st)
    assert int8_matmul.launches == n0  # the plain version on the CPU
    torch.testing.assert_close(
        int8_matmul(a_q, a_s, w_qt, w_st, w_t=w_qt.t().contiguous()), want,
        atol=0, rtol=0)
    for bad in (w_qt, w_qt.t(), w_qt.t().contiguous().float(),
                w_qt.t().contiguous()[:128]):
        with pytest.raises(ValueError, match="w_t"):
            int8_matmul(a_q, a_s, w_qt, w_st, w_t=bad)
    with pytest.raises(ValueError, match="w_t"):
        w8a8_dot(torch.from_numpy(x), w_qt, w_st, impl="pallas", w_t=w_qt)
    with pytest.raises(ValueError, match="K % 16"):
        int8_matmul(a_q[:, :120], a_s, w_qt[:120], w_st)


def _mlp_inputs(seed, M=96, H=128, N1=512):
    """The JAX package's int8_mlp test inputs, made with numpy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, H), dtype=np.float32)
    w1q, w1s = jax_mm.quantize_cols(jnp.asarray(
        rng.standard_normal((H, N1), dtype=np.float32) * 0.05))
    w2q, w2s = jax_mm.quantize_cols(jnp.asarray(
        rng.standard_normal((N1, H), dtype=np.float32) * 0.05))
    b1 = (0.1 * rng.standard_normal((1, N1))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((1, H))).astype(np.float32)
    return [np.array(x) for x in (a, w1q, w1s, b1, w2q, w2s, b2)]


@pytest.mark.parametrize("N1,gelu_impl", [
    (512, "tanh"), (2560, "tanh"), (2560, "erf"), (2560, "sigmoid")])
def test_int8_mlp_matches_jax(N1, gelu_impl):
    """One slab (N1 = 512) and two slabs of 1280 (N1 = 2560), where the
    per-(row, slab) scales and the slab-ordered fp32 sum show."""
    args = _mlp_inputs(seed=10, N1=N1)
    assert _pick_slabs(N1) == jax_mm._pick_slabs(N1) == N1 // min(N1, 1280)
    want = np.asarray(jax_mm.int8_mlp(
        jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:]),
        interpret=True, gelu_impl=gelu_impl), np.float32)
    n0 = int8_mlp.launches
    got = int8_mlp(torch.from_numpy(args[0]).bfloat16(),
                   *map(torch.from_numpy, args[1:]), gelu_impl=gelu_impl)
    assert int8_mlp.launches == n0  # the plain version on the CPU
    assert got.dtype == torch.bfloat16 and got.shape == (96, 128)
    got = got.float().numpy()
    assert (got != want).mean() <= 1e-3, (got != want).mean()
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("n1", [128, 512, 1280, 2560, 5120, 1920, 4224])
def test_pick_slabs_matches_jax(n1):
    assert _pick_slabs(n1) == jax_mm._pick_slabs(n1)


def test_int8_matmul_and_mlp_reject_bad_inputs():
    args = [torch.from_numpy(x) for x in _mlp_inputs(seed=11)]
    a = args[0].bfloat16()
    with pytest.raises(ValueError, match="gelu_impl"):
        int8_mlp(a, *args[1:], gelu_impl="relu")
    with pytest.raises(ValueError, match="N % 128"):
        int8_mlp(a, args[1][:, :200], args[2][:, :200], args[3][:, :200],
                 *args[4:])
    a_q = torch.zeros((8, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="a_scale"):
        int8_matmul(a_q, torch.ones(4, 1), args[1], args[2])
    with pytest.raises(ValueError, match="a_q int8"):
        int8_matmul(a_q.float(), torch.ones(8, 1), args[1], args[2])
