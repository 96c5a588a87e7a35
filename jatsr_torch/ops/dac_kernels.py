"""Fused DAC decode kernels: residual units and the polyphase upsample.

Ports of the JAX package's ``ops/dac_kernels.py`` (its B6-B9):

- :func:`res_unit_fused` (B9): one residual unit, snake -> 7-tap dilated
  conv -> snake -> 1x1 conv -> residual add;
- :func:`res_stage_fused` (B6): the three units of a decoder stage
  (dilations 1, 3, 9) in one launch;
- :func:`snake_conv_transpose_fused` (B7): snake -> ConvTranspose1d with
  K = 2s, by the polyphase identity
  ``flat[t*s + p] = snake(x[t]) @ w[p] + snake(x[t-1]) @ w[p+s]``,
  ``out[m] = flat[m + pad] + b``;
- :func:`snake_conv_transpose_streamed` (B8): the same product on an input
  snaked before the launch, for decoder stage 0 (Cin 1536).

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the hand-written kernel
(``csrc/dac_res.cu`` for B6 and B9, ``csrc/snake_tr.cu`` for B7: at Cin
<= 384 one wgmma kernel that snakes each row once into shared memory, at
Cin 768 a snake pass in front of B8's kernel; ``csrc/snake_tr_stream.cu``,
a wgmma GEMM, for B8) or raises.  Nothing falls back.

Rounding points, as the TPU kernels have them: snake in fp32, then bf16
(:func:`snake_b16`); bf16 x bf16 products summed in fp32; biases and the
residual added in fp32.  The plain versions cast to bf16 and back to fp32
before an fp32 matmul: a product of two bf16 values is exact in fp32, so
only the order of the fp32 sums differs from the kernels.  Snake runs in
``SNAKE_COMPUTE_DTYPE``: fp32 (the JAX package's default) or, after
``set_snake_compute_dtype("bfloat16")`` (``bench.py --snake-bf16``), in
bf16, each operation rounded; every wrapper and plain version reads the
mode when it is called.  Each wrapper's ``launches`` counts its kernel's
launches; ``b16_launches`` counts those made in bf16 mode.

Weights arrive in the JAX layout (``[K, Cin, Cout]``), in any float dtype;
the kernels read them as bf16 in that layout, so weights packed once as
bf16 (``models/from_jax.py:dac_fused_pack``) pass through uncast.

The eligibility gates and their block tables are copied from the JAX
package as module-level names: they are TPU schedule numbers, but they
decide which branch the decoder takes, and a test can shrink them on both
sides alike.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

# ---- eligibility gates (copied from the JAX package) ----------------------

_ROWS_BUDGET = 245760


def _tblk_for(c: int) -> int:
    if c >= 768:
        return 128
    t = max(512, _ROWS_BUDGET // c)
    return (t // 8) * 8


def res_unit_supported(c: int, t: int, dilation: int) -> bool:
    """Where the decoder runs a residual unit through B9."""
    cp = -(-c // 128) * 128
    return c <= 384 and t >= _tblk_for(cp) + 6 * dilation


_STAGE_MARGIN = 39  # 3*d summed over the stage's dilations (1, 3, 9)


def _stage_tblk(cp: int) -> int:
    return {128: 1920, 256: 960, 384: 384}.get(cp, max(256, 245760 // cp))


def res_stage_supported(c: int, t: int) -> bool:
    """Where the decoder runs a stage's three residual units through B6."""
    cp = -(-c // 128) * 128
    return c <= 384 and t >= _stage_tblk(cp) + 2 * _STAGE_MARGIN


_TBLK_TR = {768: 96, 384: 256, 192: 512}  # Cin with resident weights (B7)
_TBLK_TR_STREAM = 160                     # phase-streamed rows (B8)


def conv_transpose_supported(c_in: int, c_out: int, stride: int,
                             k: int, t: int) -> bool:
    """Where the decoder runs an upsample through B7 (Cin in ``_TBLK_TR``)
    or B8 (other Cin, a multiple of 128)."""
    if k != 2 * stride:
        return False
    if c_in in _TBLK_TR:
        return t >= _TBLK_TR[c_in]
    return c_in % 128 == 0 and t >= _TBLK_TR_STREAM


# ---- the snake's compute dtype ----------------------------------------------

# The dtype the snake of B6-B9 computes in (the JAX package's
# SNAKE_COMPUTE_DTYPE): "float32" (default) or "bfloat16".
SNAKE_COMPUTE_DTYPE = "float32"


def set_snake_compute_dtype(name: str) -> None:
    """Serving knob: "float32" (default) or "bfloat16".  The kernels' and
    the plain versions' snake read it at each call."""
    global SNAKE_COMPUTE_DTYPE
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"snake compute dtype {name!r} not in "
                         f"('float32', 'bfloat16')")
    SNAKE_COMPUTE_DTYPE = name


def _snake_b16_mode() -> int:
    return int(SNAKE_COMPUTE_DTYPE == "bfloat16")


# ---- plain versions -------------------------------------------------------


def snake_b16(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``x + (1/(a + 1e-9)) * sin(a*x)^2`` in ``SNAKE_COMPUTE_DTYPE``, then
    bf16: in fp32; or in bf16, x and a cast first and each operation (a x,
    sin, the square, a + bf16(1e-9), the reciprocal, the product, the sum)
    rounded to bf16, as the JAX package's chain of bf16 ops."""
    if SNAKE_COMPUTE_DTYPE == "bfloat16":
        xb, ab = x.to(torch.bfloat16), a.to(torch.bfloat16)
        eps = torch.tensor(1e-9, dtype=torch.bfloat16, device=x.device)
        return xb + torch.reciprocal(ab + eps) * torch.sin(ab * xb).square()
    xf, af = x.float(), a.float()
    return (xf + (1.0 / (af + 1e-9)) * torch.sin(af * xf).square()) \
        .to(torch.bfloat16)


def _b16(w: torch.Tensor) -> torch.Tensor:
    """bf16 values as fp32: the kernels' weight operand."""
    return w.to(torch.bfloat16).float()


def res_unit_plain(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int):
    """Plain version of B9 on ``x [B, T, C]``; ``w7 [7, C, C]``,
    ``w1 [C, C]``."""
    T = x.shape[1]
    d = dilation
    y = F.pad(snake_b16(x, alpha1).float(), (0, 0, 3 * d, 3 * d))
    w7f = _b16(w7)
    acc = y[:, :T] @ w7f[0]
    for k in range(1, 7):
        acc = acc + y[:, k * d: k * d + T] @ w7f[k]
    y2 = snake_b16(acc + b7.float(), alpha2).float()
    y3 = y2 @ _b16(w1.reshape(w1.shape[-2:]))
    return x + y3 + b1.float()


def res_stage_plain(x, w7s, b7s, w1s, b1s, alpha1s, alpha2s,
                    dilations=(1, 3, 9)):
    """Plain version of B6: three :func:`res_unit_plain` in a row, so it is
    bit-identical to composing B9's plain version."""
    for u, d in enumerate(dilations):
        x = res_unit_plain(x, w7s[u], b7s[u], w1s[u], b1s[u], alpha1s[u],
                           alpha2s[u], d)
    return x


def polyphase_plain(y, w, b, *, stride: int, padding: int,
                    output_padding: int = 0):
    """The polyphase product of B7 and B8 on the snaked bf16 ``y [B, T,
    Cin]``: ``flat[t*s + p] = y[t] @ w[p] + y[t-1] @ w[p+s] + b`` for
    t in [0, T], then ``out = flat[pad : pad + m_out]``."""
    bsz, t, ci = y.shape
    k, _, co = w.shape
    s = stride
    yf = y.float()
    cur = F.pad(yf, (0, 0, 0, 1))     # row t: y[t] (row T is zero)
    prev = F.pad(yf, (0, 0, 1, 0))    # row t: y[t-1] (row 0 is zero)
    wf = _b16(w)
    wp = wf[:s].permute(1, 0, 2).reshape(ci, s * co)
    ws = wf[s:].permute(1, 0, 2).reshape(ci, s * co)
    flat = (cur @ wp + prev @ ws) + b.float().repeat(s)
    m_out = (t - 1) * s - 2 * padding + k + output_padding
    return flat.reshape(bsz, (t + 1) * s, co)[:, padding: padding + m_out]


def snake_conv_transpose_plain(x, w, b, alpha, *, stride: int, padding: int,
                               output_padding: int = 0):
    """Plain version of B7 and B8: :func:`polyphase_plain` on
    ``snake_b16(x)``."""
    return polyphase_plain(snake_b16(x, alpha), w, b, stride=stride,
                           padding=padding, output_padding=output_padding)


# ---- wrappers -------------------------------------------------------------


def _batched(x):
    return (x[None], True) if x.dim() == 2 else (x, False)


def _check_channels(what, *widths):
    """The kernels copy 16-byte chunks of bf16 rows: channel counts must be
    multiples of 8."""
    if any(c % 8 for c in widths):
        raise ValueError(f"{what}: channel widths {widths} must be multiples "
                         f"of 8")


def res_stage_fused(x, w7s, b7s, w1s, b1s, alpha1s, alpha2s,
                    dilations=(1, 3, 9)):
    """Three chained residual units (one decoder stage) in one launch.

    Args:
        x: [T, C] or [B, T, C] fp32 activation.
        w7s: [3, 7, C, C] stacked dilated-conv kernels ([K, Cin, Cout]
            each), b7s: [3, C].
        w1s: [3, C, C] stacked 1x1 kernels, b1s: [3, C].
        alpha1s/alpha2s: [3, C] snake parameters.
    Returns:
        same shape as x, fp32.
    """
    if tuple(dilations) != (1, 3, 9):
        raise ValueError(f"res_stage_fused runs dilations (1, 3, 9), got "
                         f"{tuple(dilations)}")
    x, squeeze = _batched(x)
    c = x.shape[2]
    w1s = w1s.reshape(3, c, c)
    if x.device.type == "cpu":
        out = res_stage_plain(x, w7s, b7s, w1s, b1s, alpha1s, alpha2s)
    else:
        out = _launch_res(x, w7s, b7s, w1s, b1s, alpha1s, alpha2s,
                          tuple(dilations), "res_stage_fused")
        res_stage_fused.launches += 1
        res_stage_fused.b16_launches += _snake_b16_mode()
    return out[0] if squeeze else out


res_stage_fused.launches = 0
res_stage_fused.b16_launches = 0


def res_unit_fused(x, w7, b7, w1, b1, alpha1, alpha2, dilation: int):
    """Fused snake -> conv7(dilated, pad 3d) -> snake -> conv1x1 -> +x.

    Args:
        x: [T, C] or [B, T, C] fp32 activation.
        w7: [7, C, C] conv kernel ([K, Cin, Cout]), b7: [C].
        w1: [1, C, C] or [C, C] 1x1 kernel, b1: [C].
        alpha1/alpha2: [C] snake parameters.
    Returns:
        same shape as x, fp32.
    """
    x, squeeze = _batched(x)
    c = x.shape[2]
    w1 = w1.reshape(c, c)
    if x.device.type == "cpu":
        out = res_unit_plain(x, w7, b7, w1, b1, alpha1, alpha2, dilation)
    else:
        out = _launch_res(x, w7[None], b7[None], w1[None], b1[None],
                          alpha1[None], alpha2[None], (dilation,),
                          "res_unit_fused")
        res_unit_fused.launches += 1
        res_unit_fused.b16_launches += _snake_b16_mode()
    return out[0] if squeeze else out


res_unit_fused.launches = 0
res_unit_fused.b16_launches = 0


def _launch_res(x, w7s, b7s, w1s, b1s, a1s, a2s, dils, what):
    """B6 or B9: one cooperative launch of csrc/dac_res.cu."""
    from . import _build

    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes fp32, got {x.dtype}")
    B, T, C = x.shape
    U = len(dils)
    _check_channels(what, C)
    if w7s.shape != (U, 7, C, C) or w1s.shape != (U, C, C):
        raise ValueError(f"{what}: weights {tuple(w7s.shape)}, "
                         f"{tuple(w1s.shape)} do not fit C = {C}")
    dev = x.device
    plan = _res_plan(B, T, C, U, _sm_count(dev.index))
    lib = _res_lib()
    x = _build.aligned(x)
    rows = [_build.aligned(v.reshape(U, C).float()) for v in
            (b7s, b1s, a1s, a2s)]
    w7b = _build.aligned(w7s.to(torch.bfloat16))
    w1b = _build.aligned(w1s.to(torch.bfloat16))
    out = torch.empty_like(x)
    y = torch.empty((2, B, T, C), dtype=torch.bfloat16, device=dev)
    bar = torch.empty(2, dtype=torch.int32, device=dev)
    d = list(dils) + [0] * (3 - U)
    err = lib.res_units(x.data_ptr(), out.data_ptr(), y.data_ptr(),
                        bar.data_ptr(), w7b.data_ptr(), rows[0].data_ptr(),
                        w1b.data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
                        rows[3].data_ptr(), B, T, C, U, *d, plan.bn,
                        plan.stages, plan.smem, _snake_b16_mode(),
                        _build.stream_ptr(dev))
    _build.check(lib, err, what)
    return out


@functools.cache
def _res_lib():
    """csrc/dac_res.cu's library, its entry point's C types set."""
    from . import _build

    lib = _build.load("dac_res")
    lib.res_units.restype = ctypes.c_int
    lib.res_units.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                              + [ctypes.c_void_p])
    lib.res_snake_check.restype = ctypes.c_int
    lib.res_snake_check.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int, ctypes.c_void_p])
    return lib


def snake_check(x, a):
    """B6's batched snake (csrc/snake.cuh:snake_batch) and ``snake()`` of
    the CUDA kernels on fp32 CUDA tensors ``x`` and ``a``, elementwise:
    ``(kernel, reference)``."""
    from . import _build

    x, a = (t.float().contiguous() for t in (x, a))
    if x.shape != a.shape or x.numel() % 8:
        raise ValueError("x and a: one shape, a multiple of 8 elements")
    got, ref = torch.empty_like(x), torch.empty_like(x)
    lib = _res_lib()
    err = lib.res_snake_check(x.data_ptr(), a.data_ptr(), got.data_ptr(),
                              ref.data_ptr(), x.numel(),
                              _build.stream_ptr(x.device))
    _build.check(lib, err, "res_snake_check")
    return got, ref


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def snake_conv_transpose_fused(x, w, b, alpha, *, stride: int, padding: int,
                               output_padding: int = 0):
    """snake(x) -> conv_transpose in one kernel (B7); Cin outside
    ``_TBLK_TR`` goes to :func:`snake_conv_transpose_streamed` (B8), as in
    the JAX package.  On the card a call is one launch of csrc/snake_tr.cu
    at Cin <= 384 and two at Cin 768 (``_tr_plan``), counted once.

    Args:
        x: [B, T, Cin] fp32 (or [T, Cin]).
        w: [K, Cin, Cout] transpose-conv weights (K = 2*stride).
        b: [Cout] bias.  alpha: [Cin] snake parameter.
    Returns [B, (T-1)*stride - 2*padding + K + output_padding, Cout].
    """
    x, squeeze = _batched(x)
    k = w.shape[0]
    if k != 2 * stride:
        raise ValueError(f"polyphase transpose needs K = 2*stride, got K={k}, "
                         f"stride={stride}")
    if x.shape[2] not in _TBLK_TR:
        out = snake_conv_transpose_streamed(
            x, w, b, alpha, stride=stride, padding=padding,
            output_padding=output_padding)
    elif x.device.type == "cpu":
        out = snake_conv_transpose_plain(x, w, b, alpha, stride=stride,
                                         padding=padding,
                                         output_padding=output_padding)
    else:
        out = _launch_tr(x, alpha, w, b, stride, padding, output_padding,
                         "snake_conv_transpose_fused")
        snake_conv_transpose_fused.launches += 1
        snake_conv_transpose_fused.b16_launches += _snake_b16_mode()
    return out[0] if squeeze else out


snake_conv_transpose_fused.launches = 0
snake_conv_transpose_fused.b16_launches = 0


def snake_conv_transpose_streamed(x, w, b, alpha, *, stride: int,
                                  padding: int, output_padding: int = 0):
    """The polyphase transpose (B8) on ``snake_b16(x)``, computed before the
    launch as one elementwise pass (what the JAX package leaves to XLA).

    Args and result as :func:`snake_conv_transpose_fused`.
    """
    x, squeeze = _batched(x)
    y = snake_b16(x, alpha)
    if x.device.type == "cpu":
        out = polyphase_plain(y, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)
    else:
        out = _launch_stream(y, w, b, stride, padding, output_padding)
        snake_conv_transpose_streamed.launches += 1
        snake_conv_transpose_streamed.b16_launches += _snake_b16_mode()
    return out[0] if squeeze else out


snake_conv_transpose_streamed.launches = 0
snake_conv_transpose_streamed.b16_launches = 0


def _transpose_shapes(x, w, s, pad, op, what):
    """``(B, T, Cin, Cout, m_out)`` of a polyphase transpose, after its
    checks."""
    B, T, ci = x.shape
    k, ci2, co = w.shape
    _check_channels(what, ci, co)
    if ci2 != ci or k != 2 * s:
        raise ValueError(f"{what}: weight {tuple(w.shape)} does not fit "
                         f"Cin = {ci}, stride {s}")
    return B, T, ci, co, (T - 1) * s - 2 * pad + k + op


def _launch_tr(x, alpha, w, b, s, pad, op, what):
    """B7: fp32 x, snaked inside (csrc/snake_tr.cu).  At Cin <= 384 one
    launch of ``snake_tr_rows``; at Cin 768 the snake pass, then B8's
    polyphase GEMM (csrc/snake_tr_stream.cu), as ``_tr_plan`` says."""
    from . import _build

    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes fp32, got {x.dtype}")
    B, T, ci, co, m_out = _transpose_shapes(x, w, s, pad, op, what)
    dev = x.device
    plan = _tr_plan(B, T, ci, co, s, _sm_count(dev.index))
    lib = _tr_lib()
    x = _build.aligned(x)
    a = alpha.float().contiguous()
    if plan.route == "stream":
        y = torch.empty((B, T, ci), dtype=torch.bfloat16, device=dev)
        err = lib.snake_b16(x.data_ptr(), a.data_ptr(), y.data_ptr(), x.numel(),
                            ci, plan.snake_blocks, _snake_b16_mode(),
                            _build.stream_ptr(dev))
        _build.check(lib, err, what)
        return _launch_stream(y, w, b, s, pad, op)
    wb = _build.aligned(w.to(torch.bfloat16))
    bias = _build.aligned(b.float())
    out = torch.empty((B, m_out, co), dtype=torch.float32, device=dev)
    err = lib.snake_conv_transpose_rows(
        x.data_ptr(), a.data_ptr(), wb.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, T, ci, co, s, pad, m_out, plan.bn, plan.threads,
        plan.stages, plan.xbufs, plan.xc, plan.grid, plan.smem,
        _snake_b16_mode(), _build.stream_ptr(dev))
    _build.check(lib, err, what)
    return out


@functools.cache
def _tr_lib():
    """csrc/snake_tr.cu's library, its entry points' C types set."""
    from . import _build

    lib = _build.load("snake_tr")
    lib.snake_conv_transpose_rows.restype = ctypes.c_int
    lib.snake_conv_transpose_rows.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    lib.snake_b16.restype = ctypes.c_int
    lib.snake_b16.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                              + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


# ---- the wgmma kernels' launch plans (csrc/bf16_wgmma.cuh's core) ----------

_WG_BM, _WG_BN, _WG_BK = 128, 192, 64   # output rows, columns; stage depth
_WG_STAGES = 5                          # B8's TMA ring
_WG_THREADS = 384                       # a producer and two consumer warpgroups
_WG_A_BYTES = _WG_BM * _WG_BK * 2       # a stage's A box (and a 64-column block of h)
_WG_B_BOX = 64 * _WG_BK * 2             # one [64 k][64 n] B box
_SMEM_SM90 = 232_448                    # an sm_90 block's opt-in shared memory
_SMEM_SM = 233_472                      # an SM's shared memory, 1 KB of it kept a block
_RES_MAX_STAGES = 6                     # B6/B9's ring at most
_RES_COLS = 6                           # B6/B9's per-channel fp32 constants


@dataclasses.dataclass(frozen=True)
class ResPlan:
    """The launch of csrc/dac_res.cu (B6, B9) at one shape.  A persistent
    grid of ``grid`` CTAs (no more than fit on the card at once: the grid
    barrier needs every CTA resident) walks the ``tiles`` 128-row tiles of
    ``[B, T]``, CTA c the tiles c, c + grid, ..; a CTA owns a tile across
    all C columns, in ``halves`` column tiles of ``bn`` (96 or 192).  Per
    tile and unit the ring passes ``halves * 7 * kc`` conv7 k-blocks (A a
    box of y, B ``ceil(bn / 64)`` boxes of w7) then ``halves * kc`` conv1
    k-blocks (B only; A is h in shared memory, ``kc`` 64-column blocks of
    16 KB).  Dynamic shared memory: 1024 bytes of alignment slack, the
    ``stages`` stages of ``stage_bytes``, h, two mbarriers a stage, and a
    unit's per-channel constants (``_RES_COLS`` rows of C fp32)."""

    bn: int
    halves: int
    kc: int
    tiles: int
    stages: int
    stage_bytes: int
    h_bytes: int
    smem: int
    per_sm: int
    grid: int


@functools.cache
def _res_plan(B: int, T: int, C: int, units: int, sms: int) -> ResPlan:
    """B6's (``units`` 3) or B9's (1) launch plan on a card of ``sms``
    SMs: the mirror of csrc/dac_res.cu's ``launch`` (whose grid comes from
    the occupancy at ``smem``; here from the SM's shared memory, which
    binds first: one CTA an SM at every C).  The column tile is 96 up to
    C = 192 (at C = 192 two halves of 96 ran faster than one of 192, whose
    epilogue spills: PERF.md), else 192.  Raises ``ValueError`` for C past
    384 or not a multiple of 8."""
    if C % 8 or not 8 <= C <= 384 or T < 1 or B < 1 or units not in (1, 3):
        raise ValueError(f"res units kernel: C {C} must be a multiple of 8 "
                         f"up to 384")
    bn = 96 if C <= 192 else _WG_BN
    kc = -(-C // _WG_BK)
    stage = _WG_A_BYTES + -(-bn // 64) * _WG_B_BOX
    h_bytes = kc * _WG_A_BYTES
    cols = _RES_COLS * C * 4
    stages = min(_RES_MAX_STAGES,
                 (_SMEM_SM90 - 1024 - h_bytes - cols) // (stage + 16))
    smem = 1024 + stages * stage + h_bytes + 2 * stages * 8 + cols
    per_sm = _SMEM_SM // (smem + 1024)
    tiles = B * -(-T // _WG_BM)
    return ResPlan(bn, -(-C // bn), kc, tiles, stages, stage, h_bytes, smem,
                   per_sm, min(tiles, per_sm * sms))


# ---- B7's launch plan (csrc/snake_tr.cu) ------------------------------------

_TR_TB = 128                    # rows t a tile
_TR_ROWS = _TR_TB + 1           # x and y rows a tile: the halo t0 - 1, then t0 ..
_TR_STRIP = 130 * 16            # bytes between y's 8-channel strips
_TR_MAX_STAGES = 6              # the weight ring at most
_TR_MAX_CIN = 384               # y of a tile in shared memory: 8 strips a 64 channels


@dataclasses.dataclass(frozen=True)
class TrPlan:
    """The launch of csrc/snake_tr.cu (B7) at one shape.

    ``route`` "rows" (Cin <= 384): one launch of ``snake_tr_rows``, a
    persistent grid of ``grid`` CTAs of ``threads`` threads (a producer
    warp, ``threads / 32 - 9`` snake warps, two consumer warpgroups) walking
    the ``tiles`` tiles of ``_TR_TB`` rows t of ``[0, T]`` (``mtiles`` a
    batch element; CTA c the tiles c, c + grid, ..).  A tile reads x rows
    ``t0 - 1 .. t0 + 127`` (``_TR_ROWS``; tap 0 reads y slot ``r + 1``, tap
    1 slot ``r`` for tile row r) in chunks of ``xc`` channels through
    ``xbufs`` staging buffers, keeps y (``y_bytes``) and runs every phase and every
    column tile of ``bn`` (``ntiles`` of them) over ``2 * kc`` k-blocks of
    64 through a ring of ``stages`` weight stages of ``stage_bytes``;
    ``smem`` bytes of dynamic shared memory.  ``route`` "stream" (Cin past
    384): the snake pass on ``snake_blocks`` blocks, then B8's kernel on
    ``stream``."""

    route: str
    bn: int = 0
    ntiles: int = 0
    kc: int = 0
    mtiles: int = 0
    tiles: int = 0
    stages: int = 0
    stage_bytes: int = 0
    xbufs: int = 0
    xc: int = 0
    y_bytes: int = 0
    threads: int = 0
    smem: int = 0
    grid: int = 0
    snake_blocks: int = 0
    stream: "StreamPlan | None" = None


@functools.cache
def _tr_plan(B: int, T: int, Cin: int, Cout: int, s: int, sms: int) -> TrPlan:
    """B7's launch plan on a card of ``sms`` SMs.  Raises ``ValueError``
    where Cin is not a multiple of 64 (a k-block of 64 channels, two x
    chunks of 32) or Cout not of 8."""
    if Cin % 64 or Cout % 8 or T < 1 or B < 1 or s < 1:
        raise ValueError(f"snake_conv_transpose_fused kernel: Cin {Cin} must "
                         f"be a multiple of 64, Cout {Cout} of 8")
    if Cin > _TR_MAX_CIN:
        return TrPlan("stream", snake_blocks=min(-(-B * T * Cin // 2048),
                                                 8 * sms),
                      stream=_stream_plan(B, T, Cin, Cout, s))
    bn = 96 if Cout <= 96 else _WG_BN
    ntiles = -(-Cout // bn)
    kc = Cin // _WG_BK
    stage = -(-bn // 64) * _WG_B_BOX
    y_bytes = Cin // 8 * _TR_STRIP
    tables = (2 * Cin + ntiles * bn) * 4
    # Two x chunks in flight: 64 channels wide beside 96-column tiles (13 %
    # faster than 32 at stage 3; more chunks in flight did not help:
    # PERF.md), 32 beside 192-column tiles, where a wider pair would leave
    # room for two weight stages only.  Then as many stages as fit.
    threads, xc, xbufs = (512, 64, 2) if bn == 96 else (384, 32, 2)
    bars = 8 * (2 * _TR_MAX_STAGES + xbufs + 2 * kc + 1)
    fixed = 1024 + xbufs * tr_xbytes(xc) + y_bytes + bars + tables
    stages = min(_TR_MAX_STAGES, (_SMEM_SM90 - fixed) // stage)
    nbar = 2 * stages + xbufs + 2 * kc
    smem = (1024 + stages * stage + xbufs * tr_xbytes(xc) + y_bytes
            + 8 * (nbar + nbar % 2) + tables)
    mtiles = -(-(T + 1) // _TR_TB)
    tiles = B * mtiles
    return TrPlan("rows", bn, ntiles, kc, mtiles, tiles, stages, stage, xbufs,
                  xc, y_bytes, threads, smem, min(tiles, sms))


def tr_xbytes(xc: int) -> int:
    """Bytes of one fp32 x chunk of B7's kernel: ``_TR_ROWS`` rows of
    ``xc`` channels."""
    return _TR_ROWS * xc * 4


# ---- B8's launch plan (csrc/snake_tr_stream.cu) ------------------------------


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The launch of csrc/snake_tr_stream.cu at one shape: grid ``(mtiles
    * ntiles, s, B)``; CTA (x, p, b) takes rows t in ``[mt * 128, mt * 128 +
    128)`` (of ``[0, T]``), columns ``[nt * 192, nt * 192 + 192)`` of phase
    p, ``mt, nt = divmod(x, ntiles)``, over ``kblocks`` k-blocks of 64
    (``Cin / 64`` a tap), through a ring of ``stages`` stages of
    ``stage_bytes`` (A ``[128][64]``, B three ``[64][64]`` bf16 boxes);
    ``smem`` bytes of dynamic shared memory with the barriers and the
    1024-byte alignment (``WG_SMEM`` of csrc/bf16_wgmma.cuh)."""

    mtiles: int
    ntiles: int
    kblocks: int
    stages: int
    stage_bytes: int
    grid: tuple
    threads: int
    smem: int


@functools.cache
def _stream_plan(B: int, T: int, Cin: int, Cout: int, s: int) -> StreamPlan:
    """B8's launch plan.  Raises ``ValueError`` where Cin is not a multiple
    of 64 (a k-block would straddle the two taps) or Cout not of 8."""
    if Cin % _WG_BK or Cout % 8 or T < 1 or B < 1:
        raise ValueError(f"snake_conv_transpose_streamed kernel: Cin {Cin} "
                         f"must be a multiple of {_WG_BK}, Cout {Cout} of 8")
    mtiles = -(-(T + 1) // _WG_BM)
    ntiles = -(-Cout // _WG_BN)
    stage = (_WG_BM + _WG_BN) * _WG_BK * 2
    smem = _WG_STAGES * stage + 2 * _WG_STAGES * 8 + 1024
    return StreamPlan(mtiles, ntiles, 2 * Cin // _WG_BK, _WG_STAGES, stage,
                      (mtiles * ntiles, s, B), _WG_THREADS, smem)


@functools.cache
def _stream_lib():
    """csrc/snake_tr_stream.cu's library, its entry point's C types set."""
    from . import _build

    lib = _build.load("snake_tr_stream")
    lib.snake_conv_transpose_streamed.restype = ctypes.c_int
    lib.snake_conv_transpose_streamed.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _launch_stream(y, w, b, s, pad, op):
    """B8: the bf16 y, snaked already (csrc/snake_tr_stream.cu)."""
    from . import _build

    what = "snake_conv_transpose_streamed"
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {y.dtype}")
    B, T, ci, co, m_out = _transpose_shapes(y, w, s, pad, op, what)
    plan = _stream_plan(B, T, ci, co, s)
    lib = _stream_lib()
    dev = y.device
    y = _build.aligned(y)
    wb = _build.aligned(w.to(torch.bfloat16))
    bias = b.float().contiguous()
    out = torch.empty((B, m_out, co), dtype=torch.float32, device=dev)
    err = lib.snake_conv_transpose_streamed(
        y.data_ptr(), wb.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, ci,
        co, s, pad, m_out, plan.grid[0], plan.smem, _build.stream_ptr(dev))
    _build.check(lib, err, what)
    return out
