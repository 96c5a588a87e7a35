"""The port's fused-prologue products against the JAX package.

``int8_norm_mod_dot`` (qkv), ``int8_norm_mod_dense_gelu_quant`` (mlp_in)
and ``int8_matmul_fused`` (out_proj): the JAX kernels in interpret mode
against the port's plain PyTorch versions, at B = 2, Np = 16, H = 128,
N = 256, both norms, a modulation row per sample ``[B, H]`` and the
sampler's shared ``[1, H]`` row, zero and non-zero bias.  The JAX kernel is
always given the ``[B, H]`` rows: its ``BlockSpec`` indexes one row per
sample, and the port's ``[1, H]`` row must equal that row repeated.

Tolerances.
- ``matmul_fused`` uses only abs, max, multiply, divide and round before an
  exact int32 product: bit-equal.
- ``norm_mod_dot``: the prologue's statistics are fp32 sums in another order
  and XLA's rsqrt may differ from ``1 / sqrt`` in the last bit, which can
  move a code by one; the fp32 epilogue ``acc * s * ws + b`` may be
  contracted to an FMA by XLA, which can move the bf16 output by one ulp.
  At most 0.1% of outputs differ, each by at most one bf16 ulp (rtol 2^-7)
  (measured over 40 seeds: 1 output in 8192 in 8 of them, none in the rest).
- ``norm_mod_dense_gelu_quant``: codes equal but for at most 0.5%, by
  exactly one (as ``int8_dense_gelu_quant``'s tests: tanh and the prologue's
  last bits), scales within rtol 1e-6 (measured: all equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import int8_matmul as jax_mm
from jatsr_tpu.ops.quant import w8a8_dot as jax_w8a8_dot
from jatsr_torch.ops.int8_matmul import int8_matmul_fused, matmul_fused_plain
from jatsr_torch.ops.prologue import (_pick_bn_rows, _prologue_plain,
                                      int8_norm_mod_dense_gelu_quant,
                                      int8_norm_mod_dot, norm_mod,
                                      norm_mod_dense_gelu_quant_plain,
                                      norm_mod_dot_plain,
                                      norm_mod_dot_supported, s8_dot,
                                      s8_dot_plain, s8_gelu_quant,
                                      s8_gelu_quant_plain)
from jatsr_torch.ops.quant import round_to_bf16, w8a8_dot

from test_torch_int8_matmul import assert_codes_close

B, NP, H, N = 2, 16, 128, 256


def _inputs(seed, bias=True, n=N):
    rng = np.random.default_rng(seed)
    x = round_to_bf16(2.0 * rng.standard_normal((B, NP, H)) + 0.3)
    sc = round_to_bf16(0.5 * rng.standard_normal((B, H)))
    sh = round_to_bf16(0.5 * rng.standard_normal((B, H)))
    w_q = rng.integers(-127, 128, (H, n), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, n)) / (127 * np.sqrt(H))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((1, n)) if bias
         else np.zeros((1, n))).astype(np.float32)
    return x, sc, sh, w_q, w_s, b


def _jax(fn, x, sc, sh, w_q, w_s, b, **kw):
    return fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc), jnp.asarray(sh),
              jnp.asarray(w_q), jnp.asarray(w_s), jnp.asarray(b),
              interpret=True, **kw)


def _torch(fn, x, sc, sh, w_q, w_s, b, rows, **kw):
    """``rows="shared"`` passes the first sample's rows as ``[1, H]`` (and
    the caller gives JAX that row repeated)."""
    if rows == "shared":
        sc, sh = sc[:1], sh[:1]
    return fn(torch.from_numpy(x).bfloat16(), torch.from_numpy(sc),
              torch.from_numpy(sh), torch.from_numpy(w_q),
              torch.from_numpy(w_s), torch.from_numpy(b), **kw)


def _case(seed, rows, bias):
    x, sc, sh, w_q, w_s, b = _inputs(seed, bias)
    if rows == "shared":
        sc = np.repeat(sc[:1], B, 0)
        sh = np.repeat(sh[:1], B, 0)
    return x, sc, sh, w_q, w_s, b


CASES = pytest.mark.parametrize("norm,rows,bias", [
    ("rms", "per_sample", True), ("rms", "shared", False),
    ("layer", "per_sample", False), ("layer", "shared", True)])


@CASES
def test_norm_mod_dot_matches_jax(norm, rows, bias):
    args = _case(10, rows, bias)
    want = np.asarray(_jax(jax_mm.int8_norm_mod_dot, *args, norm=norm),
                      np.float32)
    got = _torch(int8_norm_mod_dot, *args, rows, norm=norm)
    assert got.dtype == torch.bfloat16 and got.shape == (B, NP, N)
    got = got.float().numpy()
    assert np.abs(want).mean() > 0.1
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


@CASES
def test_norm_mod_dense_gelu_quant_matches_jax(norm, rows, bias):
    args = _case(11, rows, bias)
    want_q, want_s = _jax(jax_mm.int8_norm_mod_dense_gelu_quant, *args,
                          norm=norm)
    got_q, got_s = _torch(int8_norm_mod_dense_gelu_quant, *args, rows,
                          norm=norm)
    assert got_q.dtype == torch.int8 and got_q.shape == (B, NP, N)
    assert got_s.dtype == torch.float32 and got_s.shape == (B, NP, 1)
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("gelu_impl", ["erf", "sigmoid"])
def test_norm_mod_dense_gelu_quant_gelu_forms_match_jax(gelu_impl):
    args = _case(12, "per_sample", True)
    want_q, want_s = _jax(jax_mm.int8_norm_mod_dense_gelu_quant, *args,
                          norm="rms", gelu_impl=gelu_impl)
    got_q, got_s = _torch(int8_norm_mod_dense_gelu_quant, *args,
                          "per_sample", norm="rms", gelu_impl=gelu_impl)
    assert_codes_close(got_q.numpy(), got_s.numpy(), np.asarray(want_q),
                       np.asarray(want_s))


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_shared_row_equals_repeated_row(norm):
    """The ``[1, H]`` modulation row broadcasts over the batch exactly."""
    x, sc, sh, *_ = _inputs(13)
    one = norm_mod(torch.from_numpy(x), torch.from_numpy(sc[:1]),
                   torch.from_numpy(sh[:1]), norm)
    rep = norm_mod(torch.from_numpy(x), torch.from_numpy(sc[:1]).repeat(B, 1),
                   torch.from_numpy(sh[:1]).repeat(B, 1), norm)
    torch.testing.assert_close(one, rep, atol=0, rtol=0)


@pytest.mark.parametrize("M,K,n", [(B * NP, H, N), (100, 256, 384)])
def test_matmul_fused_matches_jax(M, K, n):
    rng = np.random.default_rng(14)
    a = round_to_bf16(rng.standard_normal((M, K)))
    a[3] = 0.0  # an all-zero row: the floored scale
    w_q = rng.integers(-127, 128, (K, n), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, n)) / 127).astype(np.float32)
    want = jax_mm.int8_matmul_fused(jnp.asarray(a, jnp.bfloat16),
                                    jnp.asarray(w_q), jnp.asarray(w_s),
                                    interpret=True)
    got = int8_matmul_fused(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(w_q), torch.from_numpy(w_s))
    assert got.dtype == torch.bfloat16 and got.shape == (M, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("a_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_matmul_fused_out_dtype_matches_jax(a_dtype, out_dtype):
    """B4's other dtypes: an fp32 ``a`` and ``out_dtype`` fp32, as the JAX
    kernel takes them (``int8_matmul_fused(..., out_dtype=...)``, interpret
    mode); an all-zero row and one large value.  Bit-equal, as in bf16."""
    rng = np.random.default_rng(16)
    a = rng.standard_normal((100, 256)).astype(np.float32)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    if a_dtype == "bfloat16":
        a = round_to_bf16(a)
    w_q = rng.integers(-127, 128, (256, 384), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, 384)) / 127).astype(np.float32)
    want = jax_mm.int8_matmul_fused(jnp.asarray(a, a_dtype), jnp.asarray(w_q),
                                    jnp.asarray(w_s),
                                    out_dtype=getattr(jnp, out_dtype),
                                    interpret=True)
    got = int8_matmul_fused(torch.from_numpy(a).to(getattr(torch, a_dtype)),
                            torch.from_numpy(w_q), torch.from_numpy(w_s),
                            out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (100, 384)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_w8a8_dot_fused_takes_an_fp32_lhs():
    """``w8a8_dot(impl="fused")`` with an fp32 lhs returns fp32, equal to
    the JAX ``w8a8_dot`` (its plain path off a TPU) and to B4's fp32 plain
    version, bit for bit."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 24, 256)).astype(np.float32)
    w_q = rng.integers(-127, 128, (256, 384), dtype=np.int8)
    w_s = (rng.uniform(0.5, 1.5, (1, 384)) / 127).astype(np.float32)
    want = np.asarray(jax_w8a8_dot(jnp.asarray(x), jnp.asarray(w_q),
                                   jnp.asarray(w_s), impl="fused"))
    xt, w_qt, w_st = (torch.from_numpy(v) for v in (x, w_q, w_s))
    got = w8a8_dot(xt, w_qt, w_st, impl="fused", w_t=w_qt.t().contiguous())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = matmul_fused_plain(xt.reshape(48, 256), w_qt, w_st,
                               out_dtype=torch.float32)
    np.testing.assert_array_equal(plain.reshape(2, 24, 384).numpy(), want)


def test_w8a8_dot_fused_equals_xla_on_cpu():
    """``impl="fused"`` is the plain path on the CPU, as in the JAX package,
    and the fused kernel's plain version equals it bit for bit (the JAX
    package's ``test_fused_matches_two_stage``)."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(round_to_bf16(rng.standard_normal((2, 24, 256))))
    x = x.bfloat16()
    w_q = torch.from_numpy(rng.integers(-127, 128, (256, 384),
                                        dtype=np.int8))
    w_s = torch.from_numpy((rng.uniform(0.5, 1.5, (1, 384)) / 127).astype(
        np.float32))
    xla = w8a8_dot(x, w_q, w_s, impl="xla")
    torch.testing.assert_close(w8a8_dot(x, w_q, w_s, impl="fused"), xla,
                               atol=0, rtol=0)
    torch.testing.assert_close(
        matmul_fused_plain(x.reshape(48, 256), w_q, w_s).reshape(2, 24, 384),
        xla, atol=0, rtol=0)
    # "pallas" is the plain path on the CPU too (test_torch_int8_matmul.py
    # holds its kernel's plain version against the JAX kernel).
    torch.testing.assert_close(w8a8_dot(x, w_q, w_s, impl="pallas"), xla,
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="int8_impl"):
        w8a8_dot(x, w_q, w_s, impl="mosaic")


@pytest.mark.parametrize("n_rows", [8, 33, 40, 345, 352, 1024])
def test_eligibility_gate_matches_jax(n_rows):
    assert _pick_bn_rows(n_rows, 256) == jax_mm._pick_bn_rows(n_rows, 256)
    for h, n_out in ((1280, 1792), (1280, 5120), (128, 200), (100, 256)):
        assert norm_mod_dot_supported(n_rows, h, n_out) == \
            jax_mm.norm_mod_dot_supported(n_rows, h, n_out)


def test_wrappers_run_the_plain_version_on_cpu_and_check_shapes():
    x, sc, sh, w_q, w_s, b = (torch.from_numpy(a) for a in _inputs(16))
    x = x.bfloat16()
    n0 = (int8_norm_mod_dot.launches, int8_norm_mod_dense_gelu_quant.launches,
          int8_matmul_fused.launches)
    int8_norm_mod_dot(x, sc, sh, w_q, w_s, b)
    int8_norm_mod_dense_gelu_quant(x, sc, sh, w_q, w_s, b)
    int8_matmul_fused(x.reshape(B * NP, H), w_q, w_s)
    assert (int8_norm_mod_dot.launches,
            int8_norm_mod_dense_gelu_quant.launches,
            int8_matmul_fused.launches) == n0
    with pytest.raises(ValueError, match="scale"):
        int8_norm_mod_dot(x, sc[:, :64], sh, w_q, w_s, b)
    with pytest.raises(ValueError, match="norm"):
        int8_norm_mod_dot(x, sc, sh, w_q, w_s, b, norm="group")
    with pytest.raises(ValueError, match="N % 128"):
        int8_norm_mod_dot(x, sc, sh, w_q[:, :200], w_s[:, :200], b[:, :200])
    with pytest.raises(ValueError, match="gelu_impl"):
        int8_norm_mod_dense_gelu_quant(x, sc, sh, w_q, w_s, b,
                                       gelu_impl="relu")


def test_wrappers_take_the_kmajor_weight():
    """``w_t``, the weight K-major (``w_q.t()`` contiguous, ``[N, H]``),
    is what the card's s8 wgmma GEMM reads; on the CPU the plain versions
    read ``w_q`` and only check ``w_t``'s shape and type: the same outputs
    with it as without.  A ``w_t`` that is not ``w_q``'s transpose in shape,
    type or layout raises."""
    x, sc, sh, w_q, w_s, b = (torch.from_numpy(a) for a in _inputs(17))
    x = x.bfloat16()
    w_t = w_q.t().contiguous()
    for fn in (int8_norm_mod_dot, int8_norm_mod_dense_gelu_quant):
        got, want = fn(x, sc, sh, w_q, w_s, b, w_t=w_t), \
            fn(x, sc, sh, w_q, w_s, b)
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
        for bad in (w_q, w_q.t(), w_t.float(), w_t[:, :64]):
            with pytest.raises(ValueError, match="w_t"):
                fn(x, sc, sh, w_q, w_s, b, w_t=bad)


def test_plain_gemm_epilogues_compose_the_plain_kernels():
    """The card's GEMM entries without the prologue (``s8_dot``,
    ``s8_gelu_quant``) are held on the card against ``s8_dot_plain`` and
    ``s8_gelu_quant_plain``; on the plain prologue's codes and scales those
    give exactly the whole kernels' plain versions, and the entries take
    only tensors on the card."""
    x, sc, sh, w_q, w_s, b = (torch.from_numpy(a) for a in _inputs(18))
    x = x.bfloat16()
    a_q, s = _prologue_plain(x, sc, sh, "layer")
    torch.testing.assert_close(
        s8_dot_plain(a_q, s, w_q, w_s, b).reshape(B, NP, N),
        norm_mod_dot_plain(x, sc, sh, w_q, w_s, b, "layer"), atol=0, rtol=0)
    g_q, g_s = s8_gelu_quant_plain(a_q, s, w_q, w_s, b, "erf")
    want_q, want_s = norm_mod_dense_gelu_quant_plain(x, sc, sh, w_q, w_s, b,
                                                     "layer", "erf")
    assert torch.equal(g_q.reshape(B, NP, N), want_q)
    assert torch.equal(g_s.reshape(B, NP, 1), want_s)
    with pytest.raises(ValueError, match="a_q int8"):
        s8_dot(a_q.float(), s, w_q.t().contiguous(), w_s, b)
    with pytest.raises(ValueError, match="a_q int8"):
        s8_gelu_quant(a_q, s[:3], w_q.t().contiguous(), w_s, b)


def test_matmul_fused_takes_the_kmajor_weight():
    """B4's wrapper checks ``w_t`` as the prologue kernels do: on the CPU
    the plain version reads ``w_q`` (the same outputs with ``w_t`` as
    without, through ``w8a8_dot(impl="fused")`` too), and a ``w_t`` that is
    not ``w_q``'s transpose in shape, type or layout raises."""
    rng = np.random.default_rng(19)
    a = torch.from_numpy(round_to_bf16(rng.standard_normal((64, 256))))
    a = a.bfloat16()
    w_q = torch.from_numpy(rng.integers(-127, 128, (256, 384),
                                        dtype=np.int8))
    w_s = torch.from_numpy((rng.uniform(0.5, 1.5, (1, 384)) / 127).astype(
        np.float32))
    w_t = w_q.t().contiguous()
    want = int8_matmul_fused(a, w_q, w_s)
    torch.testing.assert_close(int8_matmul_fused(a, w_q, w_s, w_t=w_t), want,
                               atol=0, rtol=0)
    torch.testing.assert_close(w8a8_dot(a, w_q, w_s, impl="fused", w_t=w_t),
                               want, atol=0, rtol=0)
    for bad in (w_q, w_q.t(), w_t.float(), w_t[:, :64]):
        with pytest.raises(ValueError, match="w_t"):
            int8_matmul_fused(a, w_q, w_s, w_t=bad)
        with pytest.raises(ValueError, match="w_t"):
            w8a8_dot(a, w_q, w_s, impl="fused", w_t=bad)
