"""Training GQA attention with hash dropout: forward and hand-written backward.

Port of ``gqa_attention_train`` (JAX package, ``ops/attention_train.py``).
The two wrappers dispatch on the tensor's device: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the hand-written kernels
or raises.  Nothing falls back.  A bf16 input runs ``csrc/attention_train.cu``
(at head dims past 128 ``csrc/attention_wide.cu``); an fp32 one, the JAX
model at ``dtype="float32"``, the fp32 mode: the forward is
``csrc/attention_f32.cu``'s train mode, the backward
``csrc/attention_f32_bwd.cu`` (every product in fp32 on the CUDA cores, as
the JAX kernel computes at fp32).  ``launches`` counts both modes,
``f32_launches`` the fp32 one.

Dropout acts on the normalised softmax weights and uses the JAX package's
counter hash (lowbias32 over ``stream(b, h, seed) ^ (row * Np + col)``), so
the kernels, the plain versions and the JAX function draw the same mask bit
for bit.  ``b`` is the row of the global batch: ``b0`` (0 by default) plus
the row of the tensor at hand, so that a data-parallel rank holding rows
``b0 ..`` of a batch draws the masks that one call over the whole batch
draws (the JAX kernel's ``program_id(0)`` over the global array); ``h`` is
the global q head: ``h0`` (0 by default) plus the tensor's own q head, so
that a tensor-parallel rank holding q heads ``h0 ..`` (and their kv heads,
local q head ``j`` reading local kv head ``j // G``) draws the masks of
those heads of one call over all heads (the JAX kernel's ``program_id(1)``,
which GSPMD does not split).  ``Np`` is ``round_up(N, 8)``: the JAX wrapper pads to it and the
hash indexes that padded lattice, so the port keeps the lattice without the
physical pad.  PyTorch has no usable uint32 arithmetic, so the plain hash
computes in int64 and keeps 32 bits after every multiply and add.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .attention import (_FLASH_VMEM_BUDGET, F32_MAX_D, HEAD_DIMS, WIDE_COLS,
                        NaturalPlan, WidePlan, _f32, _f32_args, _launch_f32,
                        _natural_args, _natural_plan, _NaturalArgs,
                        _round_up, _row_bytes, _scale2_f32, _sm_count,
                        _smem_optin, _wide_args, _WideArgs, flash_supported,
                        pad_heads, padded_head_dim, unpad_heads)

_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF


def train_flash_supported(n: int, num_q_heads: int, num_kv_heads: int,
                          d: int) -> bool:
    """The JAX package's gate for the training kernels (a copy, so the port
    takes the kernels exactly where the JAX model takes them on a TPU)."""
    np_ = _round_up(n, 8)
    qd, kd = num_q_heads * d, num_kv_heads * d
    bwd = (3 * np_ * qd * 2 + 2 * np_ * kd * 2
           + np_ * qd * 2 + 2 * np_ * kd * 2
           + 6 * np_ * np_ * 4
           + 2 * num_kv_heads * np_ * d * 4)
    return (flash_supported(n, num_q_heads, num_kv_heads, d)
            and bwd <= _FLASH_VMEM_BUDGET)


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32) (a Python int or an int64
    tensor): the constant is split in 16-bit halves so that no product
    leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_u32(x):
    """lowbias32 finalizer on 32-bit values held in Python ints or int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _stream(seed: int, b, h):
    """Per-(batch, head) stream id; ``b`` and ``h`` may be int64 tensors."""
    return _hash_u32((b * _GOLD + h + _mul32(seed & _M32, 0x85EBCA6B)) & _M32)


def keep_threshold(rate: float) -> int:
    """``bits <= thr`` keeps a weight: ``round((1 - rate) 2^32)``, clipped."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_keep_mask(seed: int, b: int, h: int, np_: int,
                      rate: float) -> torch.Tensor:
    """Boolean keep mask ``[np_, np_]`` of (batch ``b``, head ``h``), equal
    to the JAX package's ``dropout_keep_mask``; ``seed`` is the int32's
    value (negative seeds use its bit pattern)."""
    idx = torch.arange(np_ * np_, dtype=torch.int64)
    bits = _hash_u32(_stream(seed, b, h) ^ idx)
    return (bits <= keep_threshold(rate)).reshape(np_, np_)


def _keep_mask(seed: int, B: int, hq: int, n: int, rate: float, device,
               b0: int = 0, h0: int = 0):
    """Keep masks of every (batch, head) ``[B, hq, n, n]``: the top-left
    ``n x n`` corner of each padded ``Np x Np`` lattice, batch row i keyed
    by ``b0 + i``, head j by ``h0 + j``."""
    np_ = _round_up(n, 8)
    b = torch.arange(b0, b0 + B, dtype=torch.int64,
                     device=device)[:, None, None, None]
    h = torch.arange(h0, h0 + hq, dtype=torch.int64,
                     device=device)[None, :, None, None]
    i = torch.arange(n, dtype=torch.int64, device=device)
    cell = (i[:, None] * np_ + i[None, :])[None, None]
    return _hash_u32(_stream(seed, b, h) ^ cell) <= keep_threshold(rate)


def _heads(q, k, v, hq, hkv):
    """``[B, N, H*D]`` -> ``[B, H, N, D]``, k and v repeated over the group."""
    B, N, QD = q.shape
    D, g = QD // hq, hq // hkv
    qh = q.reshape(B, N, hq, D).transpose(1, 2)
    kh = k.reshape(B, N, hkv, D).transpose(1, 2).repeat_interleave(g, 1)
    vh = v.reshape(B, N, hkv, D).transpose(1, 2).repeat_interleave(g, 1)
    return qh, kh, vh


def _probs(qh, kh, D, seed, rate, normalise, b0=0, h0=0):  # D: the scale's head dim
    """Scores of the bf16-rounded scaled q against k, fp32; then ``e`` (and
    ``l``) or ``p = e / l``; and the keep mask (None without dropout)."""
    scale2 = (1.0 / math.sqrt(D)) * math.log2(math.e)
    qs = qh * torch.tensor(scale2, dtype=qh.dtype, device=qh.device)
    s = qs.float() @ kh.float().transpose(-1, -2)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    B, H, N, _ = qh.shape
    keep = (_keep_mask(seed, B, H, N, rate, qh.device, b0, h0) if rate > 0.0
            else None)
    return (e / l if normalise else e), l, keep


def attention_train_fwd_plain(q, k, v, seed: int, num_q_heads: int,
                              num_kv_heads: int, rate: float,
                              scale_dim=None, b0: int = 0, h0: int = 0):
    """Plain PyTorch version of the forward kernel, with its rounding
    points: ``q * scale2`` with ``scale2`` in the input dtype, ``l`` summed
    before the dropout zeroing, ``rd(e) @ v`` in fp32, times ``coef / l``,
    rounded to the input dtype ``rd`` (bf16, or fp32, where no cast
    rounds).  ``scale_dim``
    (D by default): the head dim whose ``1/sqrt`` scales the scores, the
    true one where the heads are zero-padded (``attention.pad_heads``);
    ``b0``: the first batch row's row in the global batch; ``h0``: the
    first q head's head among all heads."""
    B, N, QD = q.shape
    D = QD // num_q_heads
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v, num_q_heads, num_kv_heads)
    e, l, keep = _probs(qh, kh, scale_dim or D, seed, rate, normalise=False,
                        b0=b0, h0=h0)
    if keep is not None:
        e = torch.where(keep, e, 0.0)
    coef = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    o = (e.to(dt).float() @ vh.float()) * (coef / l)
    return o.to(dt).transpose(1, 2).reshape(B, N, QD)


def attention_train_bwd_plain(q, k, v, o, do, seed: int, num_q_heads: int,
                              num_kv_heads: int, rate: float,
                              scale_dim=None, b0: int = 0, h0: int = 0):
    """Plain PyTorch version of the backward kernels, with their rounding
    points: ``delta = rowsum(do * o)`` in fp32 from the stored ``o`` and
    ``do``; ``ds = rd(p (dw - delta) scale)``; ``dv = rd(wd)^T do``,
    ``dk = ds^T q`` (q unscaled), ``dq = ds k``; dk and dv summed over the
    query group in fp32 and rounded once (``rd`` = the input dtype);
    ``scale_dim``, ``b0`` and ``h0`` as :func:`attention_train_fwd_plain`'s."""
    B, N, QD = q.shape
    hq, hkv = num_q_heads, num_kv_heads
    D, g = QD // hq, hq // hkv
    dt = q.dtype
    qh, kh, vh = _heads(q, k, v, hq, hkv)
    doh = do.to(dt).reshape(B, N, hq, D).transpose(1, 2).float()
    oh = o.reshape(B, N, hq, D).transpose(1, 2).float()
    p, _, keep = _probs(qh, kh, scale_dim or D, seed, rate, normalise=True,
                        b0=b0, h0=h0)
    dw = doh @ vh.float().transpose(-1, -2)
    wd = p
    if keep is not None:
        kc = torch.where(keep, 1.0 / (1.0 - rate), 0.0)
        dw = dw * kc
        wd = p * kc
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dw - delta) * (1.0 / math.sqrt(scale_dim or D))).to(dt).float()
    dv = wd.to(dt).float().transpose(-1, -2) @ doh
    dk = ds.transpose(-1, -2) @ qh.float()
    dq = (ds @ kh.float()).to(dt)

    def group_sum(x):  # [B, hq, N, D] -> [B, N, hkv * D]
        x = x.reshape(B, hkv, g, N, D).sum(dim=2).to(dt)
        return x.transpose(1, 2).reshape(B, N, hkv * D)

    return (dq.transpose(1, 2).reshape(B, N, QD), group_sum(dk),
            group_sum(dv))


def _check(q, k, v, hq, hkv):
    B, N, QD = q.shape
    if QD % hq or hq % hkv or k.shape != (B, N, hkv * (QD // hq)) \
            or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} do not split into {hq}/{hkv} "
                         f"heads")


def attention_train_fwd(q, k, v, seed: int, num_q_heads: int,
                        num_kv_heads: int, rate: float = 0.0, b0: int = 0,
                        h0: int = 0):
    """Forward: ``(o, stats)``.  ``stats`` is the kernel's ``[B, Hq, N, 2]``
    fp32 row max and row sum of ``exp2``, which the backward kernels read;
    None on the CPU.  ``b0``: the first batch row's row in the global batch
    (the dropout hash's batch index); ``h0``: the first q head's head among
    all heads (its head index)."""
    _check(q, k, v, num_q_heads, num_kv_heads)
    if q.device.type == "cpu":
        return attention_train_fwd_plain(q, k, v, seed, num_q_heads,
                                         num_kv_heads, rate, b0=b0,
                                         h0=h0), None
    launch = _launch_fwd_f32 if q.dtype == torch.float32 else _launch_fwd
    return launch(q, k, v, seed, num_q_heads, num_kv_heads, rate, b0, h0)


attention_train_fwd.launches = 0
attention_train_fwd.f32_launches = 0


def attention_train_bwd(q, k, v, o, do, seed: int, num_q_heads: int,
                        num_kv_heads: int, rate: float = 0.0, stats=None,
                        b0: int = 0, h0: int = 0):
    """Backward: ``(dq, dk, dv)`` in q's dtype; ``b0`` and ``h0`` as the
    forward's."""
    _check(q, k, v, num_q_heads, num_kv_heads)
    if q.device.type == "cpu":
        return attention_train_bwd_plain(q, k, v, o, do, seed, num_q_heads,
                                         num_kv_heads, rate, b0=b0, h0=h0)
    if stats is None:
        raise ValueError("the backward kernels need the forward's stats")
    launch = _launch_bwd_f32 if q.dtype == torch.float32 else _launch_bwd
    return launch(q, k, v, o, do, stats, seed, num_q_heads, num_kv_heads,
                  rate, b0, h0)


attention_train_bwd.launches = 0
attention_train_bwd.f32_launches = 0


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, hq, hkv, rate, b0, h0):
        o, stats = attention_train_fwd(q, k, v, seed, hq, hkv, rate, b0, h0)
        ctx.meta = (seed, hq, hkv, rate, b0, h0)
        ctx.save_for_backward(q, k, v, o,
                              *(() if stats is None else (stats,)))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *stats = ctx.saved_tensors
        seed, hq, hkv, rate, b0, h0 = ctx.meta
        dq, dk, dv = attention_train_bwd(q, k, v, o, do.contiguous(), seed,
                                         hq, hkv, rate,
                                         stats[0] if stats else None, b0, h0)
        return dq, dk, dv, None, None, None, None, None, None


def gqa_attention_train(q, k, v, seed: int, num_q_heads: int,
                        num_kv_heads: int, dropout_rate: float = 0.0,
                        b0: int = 0, h0: int = 0):
    """Differentiable GQA with dropout on the normalised weights.

    Args:
        q: ``[B, N, Hq*D]`` (RoPE applied, flat head-major columns).
        k/v: ``[B, N, Hkv*D]``.
        seed: the per-(step, layer) int32 stream id as a Python int;
            ignored without dropout.
        dropout_rate: drop probability on the softmax weights.
        b0: the row in the global batch of q's first row (a data-parallel
            rank's first row): the dropout hash's batch index is ``b0 + b``.
        h0: the head among all q heads of q's first head (a tensor-parallel
            rank's first head): the hash's head index is ``h0 + h``; the
            kv heads are k's and v's own (``h // (Hq / Hkv)``).
    Returns:
        ``[B, N, Hq*D]`` in q's dtype.
    """
    return _AttentionTrain.apply(q, k, v, int(seed), num_q_heads,
                                 num_kv_heads, float(dropout_rate), int(b0),
                                 int(h0))


# ---- the kernels ------------------------------------------------------------

def _kernel_args(q, k, v, hq, hkv, rate, seed):
    B, N, QD = q.shape
    D = QD // hq
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention_train kernels take bf16 or fp32 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    padded_head_dim(D)
    scale2 = float(torch.tensor((1.0 / math.sqrt(D)) * math.log2(math.e),
                                dtype=torch.bfloat16))
    coef = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    return dict(B=B, N=N, D=D, seed=seed & _M32, thr=keep_threshold(rate),
                scale2=scale2, scale=1.0 / math.sqrt(D), coef=coef,
                dropout=int(rate > 0.0))


_TILE = 64          # query rows of a backward tile
_CHUNK = 128        # keys of a backward CTA (and of a forward warp)
TRAIN_MAX_N = 768   # W <= 6 CTAs a cluster; JAX's gate stops at 680


def _bwd_groups(d: int) -> int:
    """Groups of 8 warps (16 keys a warp) in the backward's CTA: two, but
    one at head dim 128, whose dk and dv sums are 128 registers a thread
    and whose shared memory holds one group's tiles."""
    return 1 if d == 128 else 2


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """The launches of csrc/attention_train.cu at one (N, heads, head dim
    D, batch).

    ``fwd`` is the forward's plan: attention_rows.cuh's body on B16's
    layout (``_natural_plan(grouped=True, balanced=True)``: the G q-heads
    side by side over K and V, the (batch, kv-head) rounds spread evenly
    over the SMs).  The backward's main launch is a grid ``grid + (B,)``
    = (W, hkv, B) of CTAs of ``warps`` warps in
    clusters of ``cluster`` = W along x: CTA c of cluster (kv-head, batch)
    takes keys ``c * 128 .. + 127`` (``nk = 128 W``), warp w the 16 keys
    ``c * 128 + (w % 8) * 16 ..``.  Its ``groups`` groups of 8 warps (two;
    one at D = 128) take the G heads' ``T`` 64-row tiles ``groups`` at a
    time, ``steps`` steps: in step i, group g takes tile ``j = groups i +
    g`` of them (head ``kv-head * G + j // T``, rows ``(j % T) * 64 ..``),
    none where ``j >= G T``.  The partial dq of step i's tiles, float4
    column x in ``[0, groups * 16 D)`` (group ``x // (16 D)``, row ``x //
    (D / 4) % 64``), is added up and stored by CTA ``(x // (32 warps)) %
    W``.  Offsets are bytes of dynamic shared memory: K and V of the chunk,
    the q and do tiles ``[2 bufs][groups][2][64]`` rows, the row statistics
    ``[2][groups][64]`` float4, ds^T ``[groups][128 keys]`` rows of 64
    query rows plus 8, and the partial dq ``[2][groups][64]`` fp32 rows of
    D plus 8 (K, V, q and do: bf16 rows of D plus 8).  ``D`` is the kernel
    instance's head dim (:func:`padded_head_dim`)."""

    fwd: NaturalPlan
    N: int
    D: int
    hq: int
    hkv: int
    G: int
    T: int
    W: int
    steps: int
    groups: int
    k_off: int
    v_off: int
    tile_off: int
    info_off: int
    ds_off: int
    part_off: int
    grid: tuple
    cluster: int
    warps: int
    smem: int


@dataclasses.dataclass(frozen=True)
class WideTrainPlan:
    """B10 at a head dim ``D`` past 128 (a multiple of ``WIDE_COLS``),
    csrc/attention_wide.cu: ``fwd`` the wide forward's plan (the train
    epilogue); the backward a row launch, then dk/dv on a grid
    (``ceil(N / 64)``, hkv * groups, B) of 4-warp CTAs (warp w 16 keys, the
    G heads' rows in slices of 32, one column group of dk and dv), then dq
    on the forward's grid (warp w 16 rows, the keys in chunks of 64).
    ``smem``: the larger of the two backward launches' shared memory (K, V,
    q and do depth chunks and the group's columns, rows of 136 bf16)."""

    fwd: WidePlan
    N: int
    D: int
    hq: int
    hkv: int
    G: int
    groups: int
    dkdv_grid: tuple
    dq_grid: tuple
    warps: int
    smem: int


def _wide_train_plan(N, hq, hkv, D):
    row = _row_bytes(WIDE_COLS)
    dkdv = (2 * 64 + 4 * 32) * row + 32 * 16
    dq = (2 * 64 + 3 * 64) * row
    fwd = _natural_plan(N, hq, hkv, D, True, 1, 1)
    groups = D // WIDE_COLS
    return WideTrainPlan(fwd, N, D, hq, hkv, hq // hkv, groups,
                         (-(-N // 64), hkv * groups), (-(-N // 64),
                                                       hq * groups),
                         4, max(dkdv, dq))


@functools.cache
def _train_plan(N: int, hq: int, hkv: int, D: int, B: int,
                sms: int) -> TrainPlan:
    """The launch plan of B10's forward and backward at N keys, head dim
    D, batch B, on a card of ``sms`` SMs.  A head dim that is not one of
    ``HEAD_DIMS`` runs on the next one up, zero-padded; past 128 the plan
    is a :class:`WideTrainPlan`.  Raises ``ValueError`` past
    ``TRAIN_MAX_N`` (768: W <= 6 CTAs a cluster), where the forward
    outgrows shared memory (D = 128 past 640 keys; JAX's gate stops there
    below 600) or where the heads do not group."""
    if not 1 <= N <= TRAIN_MAX_N:
        raise ValueError(f"attention_train kernels: N={N} outside [1, "
                         f"{TRAIN_MAX_N}]")
    if hq % hkv:
        raise ValueError(f"{hq} q-heads do not group over {hkv} kv-heads")
    D = padded_head_dim(D)
    if D > HEAD_DIMS[-1]:
        return _wide_train_plan(N, hq, hkv, D)
    fwd = _natural_plan(N, hq, hkv, D, True, B, sms, balanced=True)
    if fwd.stream:
        raise ValueError(f"attention_train kernels: N={N} at head dim {D} "
                         f"outgrows shared memory (the forward has no "
                         f"streaming mode)")
    G = hq // hkv
    T = -(-N // _TILE)
    W = -(-N // _CHUNK)
    groups = _bwd_groups(D)
    row = _row_bytes(D)
    kv = _CHUNK * row
    tile_off = 2 * kv
    info_off = tile_off + 2 * groups * 2 * _TILE * row
    ds_off = info_off + 2 * groups * _TILE * 16
    part_off = ds_off + groups * _CHUNK * _row_bytes(_TILE)  # ds^T: [key][row]
    smem = part_off + 2 * groups * _TILE * 2 * row
    return TrainPlan(fwd, N, D, hq, hkv, G, T, W, -(-G * T // groups), groups,
                     0, kv, tile_off, info_off, ds_off, part_off, (W, hkv), W,
                     8 * groups, smem)


class _TrainRows(ctypes.Structure):
    """``TrainRows`` of csrc/attention_rows.cuh, field for field."""

    _fields_ = [("stats", ctypes.c_void_p), ("seed", ctypes.c_uint32),
                ("thr", ctypes.c_uint32), ("np", ctypes.c_int),
                ("dropout", ctypes.c_int), ("coef", ctypes.c_float),
                ("b0", ctypes.c_int), ("h0", ctypes.c_int)]


_BWD_INTS = ("N", "hq", "hkv", "G", "T", "W", "steps", "k_off", "v_off",
             "tile_off", "info_off", "ds_off", "part_off")


class _TrainBwdArgs(ctypes.Structure):
    """``TrainBwdPlan`` of csrc/attention_train.cu, field for field."""

    _fields_ = ([(f, ctypes.c_int) for f in _BWD_INTS + ("np", "dropout")]
                + [("seed", ctypes.c_uint32), ("thr", ctypes.c_uint32)]
                + [(f, ctypes.c_float) for f in ("scale2", "scale",
                                                 "coef")]
                + [("b0", ctypes.c_int), ("h0", ctypes.c_int)])


class _WideBwdArgs(ctypes.Structure):
    """``WideBwdPlan`` of csrc/attention_wide.cu, field for field."""

    _fields_ = ([(f, ctypes.c_int) for f in ("N", "hq", "hkv", "dp",
                                              "groups", "np", "dropout")]
                + [("seed", ctypes.c_uint32), ("thr", ctypes.c_uint32)]
                + [(f, ctypes.c_float) for f in ("scale2", "scale",
                                                 "coef")]
                + [("b0", ctypes.c_int), ("h0", ctypes.c_int)])


@functools.cache
def _wide_lib():
    """csrc/attention_wide.cu's library, its training entries' C types
    set."""
    from . import _build

    lib = _build.load("attention_wide")
    lib.attn_train_fwd_wide.restype = ctypes.c_int
    lib.attn_train_fwd_wide.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_WideArgs),
                                 ctypes.POINTER(_TrainRows), ctypes.c_int,
                                 ctypes.c_void_p])
    lib.attn_train_bwd_wide.restype = ctypes.c_int
    lib.attn_train_bwd_wide.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(_WideBwdArgs), ctypes.c_int,
                                  ctypes.c_void_p])
    return lib


@functools.cache
def _lib():
    """csrc/attention_train.cu's library, its entry points' C types set."""
    from . import _build

    lib = _build.load("attention_train")
    lib.attn_train_fwd.restype = ctypes.c_int
    lib.attn_train_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.POINTER(_NaturalArgs),
                                 ctypes.POINTER(_TrainRows)]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.attn_train_bwd.restype = ctypes.c_int
    lib.attn_train_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(_TrainBwdArgs)]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _plan_for(q, hq, hkv):
    B, N, QD = q.shape
    plan = _train_plan(N, hq, hkv, QD // hq, B, _sm_count(q.device.index))
    limit = _smem_optin(q.device.index)
    if max(plan.smem, plan.fwd.smem) > limit:
        raise ValueError(f"attention_train: N={N} needs "
                         f"{max(plan.smem, plan.fwd.smem)} B of shared "
                         f"memory, the card gives {limit}")
    return plan


def _launch_fwd(q, k, v, seed, hq, hkv, rate, b0=0, h0=0):
    from . import _build

    a = _kernel_args(q, k, v, hq, hkv, rate, seed)
    B, N, Dt = a["B"], a["N"], a["D"]
    D = padded_head_dim(Dt)
    q, k, v = (_build.aligned(pad_heads(t, Dt, D)) for t in (q, k, v))
    plan = _plan_for(q, hq, hkv)
    out = torch.empty_like(q)
    stats = torch.empty((B, hq, N, 2), dtype=torch.float32, device=q.device)
    fp = plan.fwd
    rows = _TrainRows(stats.data_ptr(), a["seed"], a["thr"], _round_up(N, 8),
                      a["dropout"], a["coef"], b0, h0)
    if isinstance(plan, WideTrainPlan):
        lib = _wide_lib()
        args = _wide_args(fp, hq * D, hkv * D, hkv * D, a["scale2"])
        err = lib.attn_train_fwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.byref(args), ctypes.byref(rows), B,
            _build.stream_ptr(q.device))
    else:
        lib = _lib()
        args = _natural_args(fp, hq * D, hkv * D, hkv * D, a["scale2"])
        err = lib.attn_train_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), ctypes.byref(args),
                                 ctypes.byref(rows), D, fp.launch_grid(B)[2],
                                 *fp.grid, fp.warps, fp.smem,
                                 _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_train fwd")
    attention_train_fwd.launches += 1
    return unpad_heads(out, Dt, D), stats


def _launch_bwd(q, k, v, o, do, stats, seed, hq, hkv, rate, b0=0, h0=0):
    from . import _build

    a = _kernel_args(q, k, v, hq, hkv, rate, seed)
    B, N, Dt = a["B"], a["N"], a["D"]
    if o.shape != q.shape or do.shape != q.shape \
            or stats.shape != (B, hq, N, 2):
        raise ValueError("o, do must match q and stats must be "
                         f"[{B}, {hq}, {N}, 2]")
    D = padded_head_dim(Dt)
    q, k, v, o, do = (_build.aligned(pad_heads(t.to(q.dtype), Dt, D))
                      for t in (q, k, v, o, do))
    plan = _plan_for(q, hq, hkv)
    stats = stats.float().contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if isinstance(plan, WideTrainPlan):
        info = torch.empty((B, hq, N, 4), dtype=torch.float32,
                           device=q.device)
        args = _WideBwdArgs(N, hq, hkv, D, plan.groups, _round_up(N, 8),
                            a["dropout"], a["seed"], a["thr"], a["scale2"],
                            a["scale"], a["coef"], b0, h0)
        lib = _wide_lib()
        err = lib.attn_train_bwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), stats.data_ptr(), info.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ctypes.byref(args), B,
            _build.stream_ptr(q.device))
    else:
        if B * hq * plan.T * _TILE * (plan.D // 8) >= 2 ** 31:
            raise ValueError(f"attention_train bwd: batch {B} x {hq} heads x "
                             f"{plan.T * _TILE} rows is past the kernels' "
                             f"int indexing")
        lib = _lib()
        info = torch.empty((B, hq, plan.T * _TILE, 4), dtype=torch.float32,
                           device=q.device)
        args = _TrainBwdArgs(*(getattr(plan, f) for f in _BWD_INTS),
                             _round_up(N, 8), a["dropout"], a["seed"],
                             a["thr"], a["scale2"], a["scale"], a["coef"], b0,
                             h0)
        err = lib.attn_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), stats.data_ptr(), info.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ctypes.byref(args), plan.D, B,
            plan.smem, _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_train bwd")
    attention_train_bwd.launches += 1
    return tuple(unpad_heads(t, Dt, D) for t in (dq, dk, dv))


# ---- the fp32 mode (csrc/attention_f32.cu, csrc/attention_f32_bwd.cu) -------

_F32_DP = (32, 64, 128, 256)  # attention_f32.cu's tiles: the padded head dim
_F32_THREADS = 256
_F32_ROW_INFO = 24            # bytes of attention_f32_bwd.cu's RowInfo


@dataclasses.dataclass(frozen=True)
class F32TrainPlan:
    """The backward launches of B10's fp32 mode, csrc/attention_f32_bwd.cu,
    at N keys, head dim D (``DP`` the padded one, as attention_f32.cu's
    forward pads it: its sums are the backward's scores) and hq/hkv heads.

    After a delta launch (a warp a (batch, row, q head)): dk/dv on the grid
    ``dkdv_grid + (B,)``, a CTA per (``T`` keys, kv head, batch) taking the
    kv head's G N stacked rows in chunks of ``T``; dq on ``dq_grid + (B,)``,
    a CTA per (``T`` stacked rows, kv head, batch) taking the keys in chunks
    of ``T``; ``threads`` each.  Shared memory (bytes): K, V, q and do tiles
    of ``T`` rows of ``DP + 1`` fp32, the ds (and, dk/dv, wd) tiles ``T x
    (T + 1)``, each row's statistics."""

    N: int
    D: int
    DP: int
    hq: int
    hkv: int
    G: int
    T: int
    dkdv_grid: tuple
    dq_grid: tuple
    dkdv_smem: int
    dq_smem: int
    threads: int


@functools.cache
def _f32_train_plan(N: int, hq: int, hkv: int, D: int) -> F32TrainPlan:
    """The launch plan of B10's fp32 backward; raises ``ValueError`` past
    ``TRAIN_MAX_N`` keys (the divide of ``fdiv_rn.cuh`` takes l <= 768),
    past ``F32_MAX_D`` or where the heads do not group."""
    if not 1 <= N <= TRAIN_MAX_N:
        raise ValueError(f"attention_train fp32 kernels: N={N} outside [1, "
                         f"{TRAIN_MAX_N}]")
    if not 1 <= D <= F32_MAX_D:
        raise ValueError(f"attention_train fp32 kernels take head dims 1 to "
                         f"{F32_MAX_D}, got {D}")
    if hq % hkv:
        raise ValueError(f"{hq} q-heads do not group over {hkv} kv-heads")
    DP = next(dp for dp in _F32_DP if D <= dp)
    T = 64 if DP <= 128 else 32
    tiles = 4 * T * (DP + 1) * 4
    ds = T * (T + 1) * 4
    G = hq // hkv
    return F32TrainPlan(N, D, DP, hq, hkv, G, T, (-(-N // T), hkv),
                        (-(-G * N // T), hkv),
                        tiles + 2 * ds + T * _F32_ROW_INFO,
                        tiles + ds + T * _F32_ROW_INFO, _F32_THREADS)


class _F32BwdArgs(ctypes.Structure):
    """``F32BwdArgs`` of csrc/attention_f32_bwd.cu, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "q", "k", "v", "o", "dout", "stats", "delta", "dq", "dk", "dv")]
        + [(f, ctypes.c_int) for f in ("N", "hq", "hkv", "D", "np",
                                         "dropout")]
        + [(f, ctypes.c_uint32) for f in ("seed", "thr")]
        + [(f, ctypes.c_float) for f in ("scale2", "scale", "coef")]
        + [(f, ctypes.c_int) for f in ("b0", "h0")])


@functools.cache
def _f32_bwd_lib():
    """csrc/attention_f32_bwd.cu's library, its entry point's C types set."""
    from . import _build

    lib = _build.load("attention_f32_bwd")
    lib.attention_f32_bwd.restype = ctypes.c_int
    lib.attention_f32_bwd.argtypes = (
        [ctypes.POINTER(_F32BwdArgs)] + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    return lib


def _f32_scalars(D, rate, seed):
    """The fp32 mode's scalars as the JAX kernel takes them at fp32."""
    coef = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    return dict(seed=seed & _M32, thr=keep_threshold(rate),
                dropout=int(rate > 0.0), scale2=_scale2_f32(D),
                scale=_f32(1.0 / math.sqrt(D)), coef=_f32(coef))


def _check_f32(q, k, v):
    if k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"attention_train fp32 kernels take fp32 q/k/v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def _launch_fwd_f32(q, k, v, seed, hq, hkv, rate, b0=0, h0=0):
    """B10's fp32 forward: one launch of csrc/attention_f32.cu's train mode
    -> ``(o [B, N, hq D] fp32, stats [B, hq, N, 2])``."""
    _check_f32(q, k, v)
    B, N, QD = q.shape
    D = QD // hq
    _f32_train_plan(N, hq, hkv, D)
    c = _f32_scalars(D, rate, seed)
    out = torch.empty((B, N, QD), dtype=torch.float32, device=q.device)
    stats = torch.empty((B, hq, N, 2), dtype=torch.float32, device=q.device)
    args, keep = _f32_args(q, k, v, hq, hkv, D, out, N, c["scale2"])
    args.stats = stats.data_ptr()
    args.seed, args.thr, args.np = c["seed"], c["thr"], _round_up(N, 8)
    args.dropout, args.coef = c["dropout"], c["coef"]
    args.b0, args.h0 = b0, h0
    _launch_f32("train", args, B, q.device, "attention_train fwd(fp32)")
    attention_train_fwd.launches += 1
    attention_train_fwd.f32_launches += 1
    return out, stats


def _launch_bwd_f32(q, k, v, o, do, stats, seed, hq, hkv, rate, b0=0,
                    h0=0):
    """B10's fp32 backward: three launches of csrc/attention_f32_bwd.cu
    (delta, dk/dv, dq) -> ``(dq, dk, dv)`` fp32."""
    from . import _build

    _check_f32(q, k, v)
    B, N, QD = q.shape
    D = QD // hq
    if o.shape != q.shape or do.shape != q.shape \
            or stats.shape != (B, hq, N, 2):
        raise ValueError("o, do must match q and stats must be "
                         f"[{B}, {hq}, {N}, 2]")
    plan = _f32_train_plan(N, hq, hkv, D)
    limit = _smem_optin(q.device.index)
    if max(plan.dkdv_smem, plan.dq_smem) > limit:
        raise ValueError(f"attention_train fp32 bwd needs "
                         f"{max(plan.dkdv_smem, plan.dq_smem)} B of shared "
                         f"memory, the card gives {limit}")
    q, k, v, o, do, stats = (_build.aligned(t.float())
                             for t in (q, k, v, o, do, stats))
    c = _f32_scalars(D, rate, seed)
    delta = torch.empty((B, hq, N), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = _F32BwdArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       do.data_ptr(), stats.data_ptr(), delta.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), N, hq,
                       hkv, D, _round_up(N, 8), c["dropout"], c["seed"],
                       c["thr"], c["scale2"], c["scale"], c["coef"], b0, h0)
    lib = _f32_bwd_lib()
    err = lib.attention_f32_bwd(ctypes.byref(args), plan.DP, B,
                                plan.dkdv_grid[0], plan.dq_grid[0],
                                plan.dkdv_smem, plan.dq_smem,
                                _build.stream_ptr(q.device))
    _build.check(lib, err, "attention_train bwd(fp32)")
    attention_train_bwd.launches += 1
    attention_train_bwd.f32_launches += 1
    return dq, dk, dv
