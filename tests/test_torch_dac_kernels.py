"""The port's fused DAC decode kernels (B6-B9) against the JAX package's,
and the port's fused decoder against JAX's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do (``tests/test_dac_kernels.py``), with the same block tables shrunk on
both sides where those tests shrink them.  The port's wrappers run their
plain versions here (CPU tensors).  Inputs come from a numpy seed.

Tolerance: max |port - JAX| <= 1e-3 * max |JAX| for the polyphase
transpose (B7, B8).  Both sides take the same bf16 x bf16 products summed
in fp32, but in another order, and the CPU's ``torch.sin`` and XLA's
``sin`` may differ in the last fp32 bit, which can move one bf16 input of
a product by one ulp (2^-8 relative).  The residual units (B9, B6) round
an intermediate to bf16 between their two products: a sum in another
order moves about 1 % of those intermediates by one bf16 ulp, and one such
move shifts an output by ulp(h) * |w1|.  Measured on these inputs: up to
9.9e-4 * max |JAX| for one unit, 1.6e-3 for three chained units; bound
4e-3 for both.  The decoder's waveform: max abs <= 5e-3, the fp32
decode-parity bound of ``tests/test_dac.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
from jatsr_tpu.models.dac.model import decoder_forward as jax_decoder_forward
from jatsr_tpu.models.dac.model import init_params as jax_dac_init
from jatsr_tpu.ops import dac_kernels as jdk
from jatsr_torch.models.dac import DAC, DACConfig
from jatsr_torch.ops import dac_kernels as dk

REL = 1e-3       # B7, B8
REL_UNIT = 4e-3  # B9, B6: see the module docstring


def _assert_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _unit_inputs(seed, T, C, units=None, batch=None):
    """x, w7, b7, w1, b1, a1, a2 as the JAX kernel tests draw them (with a
    leading units axis when ``units`` is given)."""
    rng = np.random.default_rng(seed)
    u = () if units is None else (units,)
    xs = (T, C) if batch is None else (batch, T, C)

    def normal(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (normal(xs), normal(u + (7, C, C), 0.05), normal(u + (C,), 0.1),
            normal(u + (C, C), 0.05), normal(u + (C,), 0.1),
            np.abs(normal(u + (C,))) + 0.5, np.abs(normal(u + (C,))) + 0.5)


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("C,T,dilation", [(128, 3200, 1), (128, 3200, 3),
                                          (128, 3200, 9), (96, 2000, 9)])
def test_res_unit_matches_jax(C, T, dilation):
    assert dk.res_unit_supported(C, T, dilation)
    assert jdk.res_unit_supported(C, T, dilation)
    j, t = _both(_unit_inputs(C + dilation, T, C))
    want = jdk.res_unit_fused(*j, dilation=dilation, interpret=True)
    got = dk.res_unit_fused(*t, dilation=dilation)
    _assert_rel(got, want, REL_UNIT)


def test_res_stage_matches_jax():
    C, T = 128, 4100  # not a multiple of the JAX block: its tail block
    assert dk.res_stage_supported(C, T) and jdk.res_stage_supported(C, T)
    j, t = _both(_unit_inputs(3, T, C, units=3))
    want = jdk.res_stage_fused(*j, interpret=True)
    got = dk.res_stage_fused(*t)
    _assert_rel(got, want, REL_UNIT)


@pytest.mark.parametrize("batch", [None, 2])
def test_res_stage_is_three_units_bit_for_bit(batch):
    x, w7s, b7s, w1s, b1s, a1s, a2s = (
        torch.from_numpy(a) for a in _unit_inputs(4, 700, 96, units=3,
                                                  batch=batch))
    got = dk.res_stage_fused(x, w7s, b7s, w1s, b1s, a1s, a2s)
    want = x
    for u, d in enumerate((1, 3, 9)):
        want = dk.res_unit_fused(want, w7s[u], b7s[u], w1s[u][None], b1s[u],
                                 a1s[u], a2s[u], dilation=d)
    assert torch.equal(got, want)


def _tr_inputs(seed, ci, co, s, T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, ci)).astype(np.float32)
    w = (rng.standard_normal((2 * s, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    a = (np.abs(rng.standard_normal(ci)) + 0.5).astype(np.float32)
    return x, w, b, a


@pytest.mark.parametrize("ci,co,s,T", [
    (192, 96, 2, 150), (192, 96, 2, 151), (384, 192, 4, 130),
    (384, 192, 4, 131), (768, 384, 8, 65), (768, 384, 8, 66)])
def test_snake_conv_transpose_matches_jax(monkeypatch, ci, co, s, T):
    table = {192: 64, 384: 64, 768: 64}
    monkeypatch.setattr(jdk, "_TBLK_TR", table)
    monkeypatch.setattr(dk, "_TBLK_TR", dict(table))
    assert dk.conv_transpose_supported(ci, co, s, 2 * s, T)
    kw = dict(stride=s, padding=math.ceil(s / 2), output_padding=s % 2)
    j, t = _both(_tr_inputs(ci + T, ci, co, s, T))
    want = jdk.snake_conv_transpose_fused(*j, **kw, interpret=True)
    got = dk.snake_conv_transpose_fused(*t, **kw)
    assert got.shape[1] == (T - 1) * s - 2 * kw["padding"] + 2 * s + s % 2
    _assert_rel(got, want)


@pytest.mark.parametrize("ci,co,s,T", [(1536, 768, 8, 40), (1024, 200, 4, 70)])
def test_snake_conv_transpose_streamed_matches_jax(monkeypatch, ci, co, s, T):
    monkeypatch.setattr(jdk, "_TBLK_TR_STREAM", 32)
    monkeypatch.setattr(dk, "_TBLK_TR_STREAM", 32)
    assert dk.conv_transpose_supported(ci, co, s, 2 * s, T)
    kw = dict(stride=s, padding=math.ceil(s / 2), output_padding=s % 2)
    j, t = _both(_tr_inputs(ci, ci, co, s, T))
    want = jdk.snake_conv_transpose_fused(*j, **kw, interpret=True)
    got = dk.snake_conv_transpose_streamed(*t, **kw)
    _assert_rel(got, want)
    # The fused entry hands a Cin outside _TBLK_TR to the streamed one.
    torch.testing.assert_close(dk.snake_conv_transpose_fused(*t, **kw), got,
                               atol=0, rtol=0)


def _record(monkeypatch, module, names, calls, kind_of):
    for name in names:
        fn = getattr(module, name)

        def wrapper(*a, _fn=fn, _name=name, **kw):
            calls.append(kind_of(_name, a, kw))
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)


def _kind(name, a, kw):
    x = a[0]
    if name == "res_unit_fused":
        return ("B9", x.shape[-1], x.shape[-2], kw["dilation"])
    if name == "res_stage_fused":
        return ("B6", x.shape[-1], x.shape[-2])
    if name == "snake_conv_transpose_streamed":
        return ("B8", x.shape[-1], x.shape[-2])
    return ("tr", x.shape[-1], x.shape[-2])


# (frames, expected calls): 172 frames is the JAX package's fused-decoder
# geometry (B8 at stage 0, B7 and B6 at stages 1-3); at 4 frames stage 2's
# T = 1024 is too short for B6 but long enough for B9, and the first two
# upsamples are too short for B8/B7.
DECODES = [(172, {"B8": 1, "tr": 4, "B6": 3, "B9": 0}),
           (4, {"B8": 0, "tr": 2, "B6": 1, "B9": 3})]


@pytest.mark.parametrize("frames,expected", DECODES)
def test_fused_decoder_matches_jax_and_takes_the_same_branches(
        monkeypatch, frames, expected):
    monkeypatch.setattr(jdk, "ALLOW_INTERPRET_DISPATCH", True)
    cfg = DACConfig()
    params = jax_dac_init(jax.random.PRNGKey(0), JaxDACConfig())
    codec = DAC(_numpy_tree(params["decoder"]), cfg, fused_res_units=True,
                device="cpu")
    z = np.random.default_rng(1).standard_normal(
        (1, frames, cfg.latent_dim)).astype(np.float32)

    jax_calls, port_calls = [], []
    entries = ["res_unit_fused", "res_stage_fused",
               "snake_conv_transpose_fused"]
    _record(monkeypatch, jdk, entries, jax_calls, _kind)
    _record(monkeypatch, dk, entries + ["snake_conv_transpose_streamed"],
            port_calls, _kind)
    want = jax_decoder_forward(params, jnp.asarray(z), JaxDACConfig(),
                               fused_res_units=True)
    got = codec.decode(torch.from_numpy(z))

    assert [c for c in port_calls if c[0] != "B8"] == jax_calls
    b8 = [c for c in jax_calls if c[0] == "tr" and c[1] not in dk._TBLK_TR]
    assert [c for c in port_calls if c[0] == "B8"] == \
        [("B8",) + c[1:] for c in b8]
    counts = {k: sum(c[0] == k for c in port_calls) for k in expected}
    assert counts == expected, counts
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (1, frames * 512, 1)
    assert float(np.abs(got - want).max()) <= 5e-3


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_port_fused_decoder_matches_its_unfused_decoder():
    """The JAX package's fused-vs-unfused bound (5e-2,
    ``tests/test_dac_kernels.py``) on the port alone, at 172 frames."""
    from jatsr_torch.models.dac.model import init_decoder_params

    cfg = DACConfig()
    dec = init_decoder_params(cfg, seed=2)
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 172, cfg.latent_dim)).astype(np.float32))
    fused = DAC(dec, cfg, fused_res_units=True, device="cpu").decode(z)
    plain = DAC(dec, cfg, device="cpu").decode(z)
    assert fused.shape == plain.shape == (1, 172 * 512, 1)
    assert float((fused - plain).abs().max()) < 5e-2


def test_dac_fused_res_units_no_longer_raises():
    small = DACConfig(encoder_dim=256, encoder_rates=(2, 4), decoder_dim=16,
                      decoder_rates=(4, 2))
    codec = DAC.random_init(0, small, fused_res_units=True, device="cpu")
    assert codec.fused_res_units
    packed = codec.decoder["block_0"]["fused"]
    assert packed["up_w"].dtype == torch.bfloat16
    assert packed["w7s"].shape == (3, 7, 8, 8)
    wav = codec.decode(torch.zeros(1, 5, small.latent_dim))
    assert wav.shape == (1, 5 * small.hop_length, 1)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    n0 = (dk.res_stage_fused.launches, dk.res_unit_fused.launches,
          dk.snake_conv_transpose_fused.launches,
          dk.snake_conv_transpose_streamed.launches)
    x, w7, b7, w1, b1, a1, a2 = (torch.from_numpy(a)
                                 for a in _unit_inputs(5, 64, 16))
    dk.res_unit_fused(x, w7, b7, w1, b1, a1, a2, dilation=1)
    xt, w, b, a = (torch.from_numpy(v) for v in _tr_inputs(6, 192, 96, 2, 9))
    dk.snake_conv_transpose_fused(xt, w, b, a, stride=2, padding=1,
                                  output_padding=0)
    assert (dk.res_stage_fused.launches, dk.res_unit_fused.launches,
            dk.snake_conv_transpose_fused.launches,
            dk.snake_conv_transpose_streamed.launches) == n0


# ---- B8's launch plan (csrc/snake_tr_stream.cu), on the CPU ----------------
# ``_stream_plan`` is pure Python.  The enumeration follows the kernel's own
# indexing: CTA (x, p, b) takes rows t of ``[mt * 128, mt * 128 + 128)`` and
# columns ``[nt * 192, nt * 192 + 192)`` of phase p, ``mt, nt = divmod(x,
# ntiles)``, and its epilogue writes out[b, t * s + p - pad] where t <= T
# and 0 <= m < m_out.

@pytest.mark.parametrize("B,T,ci,co,s", [(1, 2884, 1536, 768, 8),
                                         (2, 77, 1024, 200, 4),
                                         (1, 300, 1536, 768, 8),
                                         (3, 160, 128, 64, 2)])
def test_stream_plan_fits_and_writes_each_output_once(B, T, ci, co, s):
    """Stage 0 at one decode segment, the card test's odd shape (Cout 200,
    T 77: one partial row tile), a T + 1 that is not a multiple of the row
    tile, and the smallest Cin the gate takes at s 2."""
    plan = dk._stream_plan(B, T, ci, co, s)
    pad, op = (s + 1) // 2, s % 2
    m_out = (T - 1) * s - 2 * pad + 2 * s + op
    assert plan.smem <= 232_448 and plan.threads == 384
    assert plan.stages >= 3 and plan.stage_bytes == (128 + 192) * 64 * 2
    assert plan.kblocks * 64 == 2 * ci            # Cin / 64 k-blocks a tap
    assert plan.mtiles * 128 >= T + 1 > (plan.mtiles - 1) * 128
    assert plan.ntiles * 192 >= co > (plan.ntiles - 1) * 192
    assert plan.grid == (plan.mtiles * plan.ntiles, s, B)
    count = np.zeros((B, m_out, plan.ntiles), np.int64)
    for x in range(plan.grid[0]):
        mt, nt = divmod(x, plan.ntiles)
        t = np.arange(mt * 128, mt * 128 + 128)
        for p in range(s):
            m = t * s + p - pad
            m = m[(t <= T) & (m >= 0) & (m < m_out)]
            for b in range(B):
                np.add.at(count[b, :, nt], m, 1)
    assert (count == 1).all()


@pytest.mark.parametrize("ci,co", [(96, 64), (128, 100)])
def test_stream_plan_raises_where_the_kernel_cannot_tile(ci, co):
    with pytest.raises(ValueError):
        dk._stream_plan(1, 300, ci, co, 8)


# ---- B6's and B9's launch plan (csrc/dac_res.cu), on the CPU ---------------
# ``_res_plan`` is pure Python, the mirror of the kernel's ``launch``.  The
# enumeration follows the kernel's own indexing: CTA c of the persistent
# grid takes tiles c, c + grid, ..; tile x is batch x // mtiles, rows
# ``(x % mtiles) * 128 + [0, 128)``; consumer warpgroup wg (1, 2), warp w,
# lane l hold rows ``(wg - 1) * 64 + 16 w + l // 4 + 8 e`` and columns
# ``hf * bn + 8 i + 2 (l % 4) + {0, 1}`` of each half hf, and the epilogue
# writes those below T and C.

def _res_tile_cover(bn):
    """How often the threads of a tile hold each (row, column) of its 128 x
    bn outputs."""
    wg, w, lane, e, i, f = np.meshgrid(
        np.arange(1, 3), np.arange(4), np.arange(32), np.arange(2),
        np.arange(bn // 8), np.arange(2), indexing="ij")
    rows = (wg - 1) * 64 + 16 * w + lane // 4 + 8 * e
    cols = 8 * i + 2 * (lane % 4) + f
    count = np.zeros((128, bn), np.int64)
    np.add.at(count, (rows.ravel(), cols.ravel()), 1)
    return count


@pytest.mark.parametrize("B,T,C", [(1, 184_576, 384), (1, 738_304, 192),
                                   (1, 1_476_608, 96), (2, 777, 96),
                                   (2, 1001, 192), (2, 333, 384),
                                   (2, 130, 136)])
def test_res_plan_fits_and_writes_each_output_once(B, T, C):
    """The decode's three stage shapes (one 2884-frame segment), the card
    tests' odd shapes at B = 2 (T not a multiple of 128), and a C that is
    not a multiple of 64: the dynamic shared memory fits an sm_90 block,
    the grid is no larger than the CTAs the card holds at once (the grid
    barrier needs them all resident), and each unit writes every (batch,
    row, column) of out once."""
    plan = dk._res_plan(B, T, C, 3, 132)
    assert plan.smem <= 232_448
    assert plan.per_sm >= 1 and plan.per_sm * (plan.smem + 1024) <= 233_472
    assert plan.grid <= plan.per_sm * 132 and plan.grid <= plan.tiles
    assert plan.bn == (96 if C <= 192 else 192)
    assert plan.halves * plan.bn >= C > (plan.halves - 1) * plan.bn
    assert plan.kc * 64 >= C > (plan.kc - 1) * 64
    assert plan.h_bytes == plan.kc * 128 * 128       # h: [128 rows][kc * 64]
    assert plan.stages >= 3
    mtiles = -(-T // 128)
    assert plan.tiles == B * mtiles
    assert (_res_tile_cover(plan.bn) == 1).all()
    row_count = np.zeros((B, T), np.int64)
    for c in range(plan.grid):
        for x in range(c, plan.tiles, plan.grid):
            t = (x % mtiles) * 128 + np.arange(128)
            np.add.at(row_count[x // mtiles], t[t < T], 1)
    assert (row_count == 1).all()
    col_count = np.zeros(C, np.int64)
    for hf in range(plan.halves):
        n = hf * plan.bn + np.arange(plan.bn)
        np.add.at(col_count, n[n < C], 1)
    assert (col_count == 1).all()


@pytest.mark.parametrize("C", [100, 392])
def test_res_plan_raises_where_the_kernel_cannot_tile(C):
    with pytest.raises(ValueError):
        dk._res_plan(1, 1000, C, 3, 132)


# ---- B7's launch plan (csrc/snake_tr.cu), on the CPU -----------------------
# ``_tr_plan`` is pure Python.  The enumeration follows the kernel's own
# indexing at Cin <= 384: CTA c of the persistent grid takes tiles c, c +
# grid, ..; tile x is batch x // mtiles, rows t of ``(x % mtiles) * 128 +
# [0, 128)``; its x box starts at row t0 - 1 and holds ``_TR_ROWS`` rows, so
# slot j is row t0 - 1 + j (tap 0 of row t reads slot t - t0 + 1, tap 1 slot
# t - t0); for every phase p and column tile nt the epilogue writes out[b, t
# * s + p - pad] where t <= T and 0 <= m < m_out.  At Cin 768 the plan is
# the snake pass and B8's plan (whose cover is tested above).

_TR_STAGES = {768: (384, 8, 23_072), 384: (192, 4, 184_576),
              192: (96, 2, 738_304)}  # Cout, stride, T of one decode segment


@pytest.mark.parametrize("ci", [768, 384, 192])
@pytest.mark.parametrize("B,T", [(1, None), (2, 1), (2, 127), (2, 128),
                                 (2, 129)])
def test_tr_plan_fits_and_writes_each_output_once(B, T, ci):
    """The three stage shapes at one decode segment, and T = 1, 127, 128,
    129 (no full tile, one, one and the row t = T alone, two) at batch 2:
    the dynamic shared memory fits an sm_90 block, each output row of each
    batch element is written once, by the tile whose x rows hold both of its
    taps, and the column tiles cover Cout once."""
    co, s, seg_t = _TR_STAGES[ci]
    T = T or seg_t
    plan = dk._tr_plan(B, T, ci, co, s, 132)
    pad, op = (s + 1) // 2, s % 2
    m_out = (T - 1) * s - 2 * pad + 2 * s + op
    if ci > 384:
        assert plan.route == "stream"
        assert plan.stream == dk._stream_plan(B, T, ci, co, s)
        assert 1 <= plan.snake_blocks <= 8 * 132
        return
    assert plan.route == "rows"
    assert plan.smem <= 232_448 and plan.threads in (384, 512)
    assert plan.threads // 32 - 1 - 8 >= 3       # snake warps
    assert plan.stages >= 3 and plan.xbufs == 2 and plan.xc in (32, 64)
    assert plan.bn == (96 if co <= 96 else 192)
    assert plan.ntiles * plan.bn >= co > (plan.ntiles - 1) * plan.bn
    assert plan.kc * 64 == ci and plan.y_bytes == ci // 8 * 130 * 16
    assert plan.stage_bytes == -(-plan.bn // 64) * 64 * 64 * 2
    nbar = 2 * plan.stages + plan.xbufs + 2 * plan.kc
    assert plan.smem == (1024 + plan.stages * plan.stage_bytes
                         + plan.xbufs * dk.tr_xbytes(plan.xc) + plan.y_bytes
                         + 8 * (nbar + nbar % 2)
                         + (2 * ci + plan.ntiles * plan.bn) * 4)
    assert plan.mtiles * 128 >= T + 1 > (plan.mtiles - 1) * 128
    assert plan.tiles == B * plan.mtiles
    assert plan.grid == min(plan.tiles, 132)
    walked = np.concatenate([np.arange(c, plan.tiles, plan.grid)
                             for c in range(plan.grid)])
    assert (np.bincount(walked, minlength=plan.tiles) == 1).all()
    tile = np.arange(plan.tiles)
    b, t0 = tile // plan.mtiles, (tile % plan.mtiles) * 128
    t = t0[:, None] + np.arange(128)[None]
    slot0, slot1 = t - (t0[:, None] - 1), t - 1 - (t0[:, None] - 1)
    assert ((slot0 >= 1) & (slot0 < dk._TR_ROWS)).all()
    assert ((slot1 >= 0) & (slot1 < dk._TR_ROWS - 1)).all()
    count = np.zeros(B * m_out, np.int64)
    for p in range(s):
        m = t * s + p - pad
        ok = (t <= T) & (m >= 0) & (m < m_out)
        np.add.at(count, (b[:, None] * m_out + m)[ok], 1)
    assert (count == 1).all()
    cols = np.zeros(co, np.int64)
    for nt in range(plan.ntiles):
        n = nt * plan.bn + np.arange(plan.bn)
        np.add.at(cols, n[n < co], 1)
    assert (cols == 1).all()


@pytest.mark.parametrize("ci,co", [(96, 48), (200, 96), (384, 100)])
def test_tr_plan_raises_where_the_kernel_cannot_tile(ci, co):
    with pytest.raises(ValueError):
        dk._tr_plan(1, 300, ci, co, 4, 132)
