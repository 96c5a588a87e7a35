"""The port's training attention (B10's plain versions, the dropout hash and
the autograd wrapper) against the JAX package's ``gqa_attention_train`` in
Pallas interpret mode.

Inputs are fp32 and made with numpy from a seed.  Tolerances are the JAX
package's own for this kernel (``tests/test_attention_train.py``): forward
2e-5, gradients 5e-4.  The keep mask is bit-equal.  The CUDA kernels'
launch plan, pure Python, is checked here too (the kernels themselves run
on a card only: ``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.ops import attention_train as jat
from jatsr_torch.ops import attention_train as tat


@pytest.mark.parametrize("seed", [0, 12345, -7, -2 ** 31, 2 ** 31 - 1])
@pytest.mark.parametrize("b,h,np_", [(0, 0, 64), (3, 5, 352), (27, 19, 48)])
def test_dropout_keep_mask_bit_equal(seed, b, h, np_):
    want = np.asarray(jat.dropout_keep_mask(jnp.int32(seed), b, h, np_, 0.1))
    got = tat.dropout_keep_mask(seed, b, h, np_, 0.1).numpy()
    np.testing.assert_array_equal(got, want)


def test_keep_fraction_and_lattice():
    """The [B, H, N, N] mask of the plain versions is each (b, h) lattice's
    top-left N x N corner, and keeps ~(1 - rate)."""
    keep = tat._keep_mask(-5, 2, 3, 45, 0.3, "cpu")
    for b in range(2):
        for h in range(3):
            lattice = tat.dropout_keep_mask(-5, b, h, 48, 0.3)
            assert torch.equal(keep[b, h], lattice[:45, :45])
    assert abs(keep.float().mean().item() - 0.7) < 0.02


@pytest.mark.parametrize("n", [64, 80, 345, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (20, 4, 64)])
def test_train_flash_supported_matches_jax(n, hq, hkv, d):
    assert tat.train_flash_supported(n, hq, hkv, d) == \
        jat.train_flash_supported(n, hq, hkv, d)


def _inputs(B, N, hq, hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, w * D), dtype=np.float32)
            for w in (hq, hkv, hkv, hq)]


CASES = pytest.mark.parametrize("N,rate,seed", [
    (64, 0.0, 0), (64, 0.25, 12345), (45, 0.0, 0), (45, 0.25, -99)])


@CASES
def test_forward_matches_jax(N, rate, seed):
    B, hq, hkv, D = 2, 4, 2, 32
    q, k, v, _ = _inputs(B, N, hq, hkv, D, 1)
    want = jat.gqa_attention_train(q, k, v, jnp.array([seed], jnp.int32), hq,
                                   hkv, dropout_rate=rate, interpret=True)
    got, stats = tat.attention_train_fwd(
        *map(torch.from_numpy, (q, k, v)), seed, hq, hkv, rate)
    assert stats is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@CASES
def test_gradients_match_jax(N, rate, seed):
    """The autograd wrapper (the plain backward on the CPU) against
    ``jax.grad`` through the hand-written VJP."""
    B, hq, hkv, D = 2, 4, 2, 16
    q, k, v, r = _inputs(B, N, hq, hkv, D, 2)
    sd = jnp.array([seed], jnp.int32)

    def f(q, k, v):
        return jnp.sum(jat.gqa_attention_train(q, k, v, sd, hq, hkv,
                                               dropout_rate=rate,
                                               interpret=True) * r)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n0 = (tat.attention_train_fwd.launches, tat.attention_train_bwd.launches)
    out = tat.gqa_attention_train(tq, tk, tv, seed, hq, hkv, rate)
    (out * torch.from_numpy(r)).sum().backward()
    assert (tat.attention_train_fwd.launches,
            tat.attention_train_bwd.launches) == n0
    np.testing.assert_allclose(
        float((out.detach() * torch.from_numpy(r)).sum()), float(f(q, k, v)),
        rtol=1e-5)
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{name}")


def test_bf16_plain_keeps_the_rounding_points():
    """In bf16 the plain forward equals the JAX kernel's interpret-mode
    result to one bf16 ulp (both round q', e and o at the same points)."""
    B, N, hq, hkv, D = 2, 40, 4, 2, 32
    q, k, v, _ = _inputs(B, N, hq, hkv, D, 3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jat.gqa_attention_train(
        *bf, jnp.array([3], jnp.int32), hq, hkv, dropout_rate=0.1,
        interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tat.attention_train_fwd_plain(tq, tk, tv, 3, hq, hkv, 0.1).float()
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_rank_heads_at_h0_equal_those_of_the_whole_call(dtype):
    """A tensor-parallel rank's heads (q heads ``h0 ..``, their kv heads)
    at ``h0``: the keep masks bit-equal to JAX's at the global heads; the
    forward and the gradients bit-equal to the same heads of the plain
    whole call and, against JAX's whole call in interpret mode, within
    this file's bounds (fp32; bf16: the forward to one ulp)."""
    B, N, hq, hkv, D, M, rate, seed = 2, 45, 4, 2, 16, 2, 0.25, -99
    q, k, v, r = _inputs(B, N, hq, hkv, D, 4)
    sd = jnp.array([seed], jnp.int32)
    jdt = jnp.dtype(dtype)

    def f(q, k, v):
        o = jat.gqa_attention_train(q, k, v, sd, hq, hkv, dropout_rate=rate,
                                    interpret=True)
        return jnp.sum(o.astype(jnp.float32) * r), o

    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    (_, jo), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        *jin)
    jo, jg = np.asarray(jo, np.float32), [np.asarray(g, np.float32)
                                          for g in jg]
    tdt = getattr(torch, dtype)
    whole = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    o = tat.gqa_attention_train(*whole, seed, hq, hkv, rate)
    (o.float() * torch.from_numpy(r)).sum().backward()
    qd, kd = hq // M * D, hkv // M * D
    for rank in range(M):
        h0 = rank * hq // M
        keep = tat._keep_mask(seed, B, hq // M, N, rate, "cpu", h0=h0)
        for h in range(hq // M):
            want = np.asarray(jat.dropout_keep_mask(sd[0], 1, h0 + h, 48,
                                                    rate))[:N, :N]
            np.testing.assert_array_equal(keep[1, h].numpy(), want)
        qs, ks = slice(rank * qd, (rank + 1) * qd), slice(rank * kd,
                                                         (rank + 1) * kd)
        mine = [t.detach()[..., s].clone().requires_grad_()
                for t, s in zip(whole, (qs, ks, ks))]
        om = tat.gqa_attention_train(*mine, seed, hq // M, hkv // M, rate,
                                     h0=h0)
        (om.float() * torch.from_numpy(r[..., qs])).sum().backward()
        assert torch.equal(om, o.detach()[..., qs])
        for t, w, s in zip(mine, whole, (qs, ks, ks)):
            assert torch.equal(t.grad, w.grad[..., s])
        if dtype == "float32":
            np.testing.assert_allclose(om.detach().numpy(), jo[..., qs],
                                       atol=2e-5, rtol=2e-5)
            for t, g, s in zip(mine, jg, (qs, ks, ks)):
                np.testing.assert_allclose(t.grad.numpy(), g[..., s],
                                           atol=5e-4, rtol=5e-4)
        else:
            np.testing.assert_allclose(om.detach().float().numpy(),
                                       jo[..., qs],
                                       atol=2.0 ** -8 * np.abs(jo).max())


# ---- the kernels' launch plan (csrc/attention_train.cu), on the CPU --------
# ``_train_plan`` is pure Python.  The enumerations below follow the
# kernels' own indexing: the forward is attention_natural.cu's body on
# balanced rounds (round rd of CTA x is f = x * span + rd of the flattened
# list: (batch, y) = divmod(f // per_y, ny), tile = f % per_y //
# head_rounds, hr = f % per_y % head_rounds; it covers rows tile * rows +
# (pair % R) * 16 + [0, 16) of q-head y * heads + hr * hc + pair // R);
# the backward's CTA c of cluster (kv-head,
# batch) owns keys c * 128 + (w % 8) * 16 + [0, 16) by warp w, and in step
# i its group g takes tile j = 2 i + g of the G * T (head, 64-row tile)
# pairs; float4 column x of step i's partial dq is stored by CTA
# (x // 512) % W.

SMEM_SM90 = 232_448     # an sm_90 block's opt-in shared memory (227 KB)
SMS = 132               # an H100 SXM's SMs
PLAN_N = [1, 7, 8, 45, 127, 128, 129, 345, 480, 600, 768]


def row_bytes(D):
    """Bytes of a D-wide bf16 row plus its 8 pad."""
    return 2 * D + 16


def _fwd_coverage(plan, B):
    """How often the forward computes and stores each (batch, row, q-head)."""
    count = np.zeros((B, plan.N, plan.hq), np.int64)
    R = plan.rows // 16
    pairs = plan.warps // plan.W
    per_y, ny = plan.row_rounds * plan.head_rounds, plan.hq // plan.heads
    for x in range(plan.grid[0]):
        for rd in range(min(plan.span, plan.total - x * plan.span)):
            f = x * plan.span + rd
            b, y = divmod(f // per_y, ny)
            tile, hr = divmod(f % per_y, plan.head_rounds)
            for pair in range(pairs):
                slot = hr * plan.hc + pair // R
                if slot >= plan.heads:
                    continue
                rows = tile * plan.rows + (pair % R) * 16 + np.arange(16)
                rows = rows[rows < plan.N]
                count[b, rows, y * plan.heads + slot] += 1
    return count


def _bwd_coverage(plan, B):
    """How often the backward's tiles take each (batch, q-head, row), its
    warps own each (batch, kv-head, key) and its CTAs store each (batch,
    q-head, row, float4 column of dq)."""
    c4 = plan.D // 4  # float4 columns of a dq row
    rows = np.zeros((B, plan.hq, plan.N), np.int64)
    keys = np.zeros((B, plan.hkv, plan.N), np.int64)
    dq = np.zeros((B, plan.hq, plan.N, c4), np.int64)
    W, hkv = plan.grid
    assert (W, plan.cluster) == (plan.W, plan.W)
    groups = plan.groups

    def tile(kvh, i, g):
        j = groups * i + g
        if j >= plan.G * plan.T:
            return None, plan.T * 64
        return kvh * plan.G + j // plan.T, (j % plan.T) * 64

    threads = plan.warps * 32
    for b in range(B):
        for kvh in range(hkv):
            for c in range(W):
                for w in range(8):  # a group's warps; each group the same
                    k = c * 128 + w * 16 + np.arange(16)
                    keys[b, kvh, k[k < plan.N]] += 1
                for i in range(plan.steps):
                    for g in range(groups):
                        h, row0 = tile(kvh, i, g)
                        r = row0 + np.arange(64)
                        if h is not None and c == 0:  # every CTA: the same
                            rows[b, h, r[r < plan.N]] += 1
                    cols = groups * 64 * c4
                    for start in range(c * threads, cols, W * threads):
                        for x in range(start, min(start + threads, cols)):
                            h, row0 = tile(kvh, i, x // (64 * c4))
                            row = row0 + (x // c4) % 64
                            if row < plan.N:
                                dq[b, h, row, x % c4] += 1
    return rows, keys, dq


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 5])
@pytest.mark.parametrize("N", PLAN_N)
def test_train_plan_fits_and_covers_once(N, G, D):
    """At head dim 128 the forward's CTAs have 8 warps, the backward's one
    group of 8; past 640 keys there the forward outgrows shared memory
    (it has no streaming mode) and the plan raises (JAX's gate stops below
    600 at head dim 128)."""
    B, hkv = 2, 2
    if D == 128 and N > 640:
        with pytest.raises(ValueError):
            tat._train_plan(N, G * hkv, hkv, D, B, SMS)
        return
    plan = tat._train_plan(N, G * hkv, hkv, D, B, SMS)
    row = row_bytes(D)
    fwd = plan.fwd
    groups = 1 if D == 128 else 2
    # Forward: B16's grid of attention_natural.cu's body.
    assert fwd.smem <= SMEM_SM90 and not fwd.stream
    assert fwd.warps <= (8 if D == 128 else 16)
    assert fwd.heads == G and fwd.grid[1] == 1 and fwd.nk >= N
    assert fwd.grid[0] <= SMS and fwd.total == B * hkv * fwd.row_rounds \
        * fwd.head_rounds and (fwd.grid[0] - 1) * fwd.span < fwd.total
    assert (_fwd_coverage(fwd, B) == 1).all()
    # Backward: clusters of W CTAs of 128 keys, at most 8 a cluster.
    assert plan.W * 128 >= N > (plan.W - 1) * 128 and plan.cluster <= 8
    assert plan.T * 64 >= N > (plan.T - 1) * 64
    assert plan.groups == groups
    assert groups * plan.steps >= G * plan.T > groups * (plan.steps - 1)
    assert plan.warps == 8 * groups and plan.smem <= SMEM_SM90
    regions = [(plan.k_off, 128 * row), (plan.v_off, 128 * row),
               (plan.tile_off, 2 * groups * 2 * 64 * row),
               (plan.info_off, 2 * groups * 64 * 16),
               (plan.ds_off, groups * 128 * row_bytes(64)),  # ds^T: 64 rows
               (plan.part_off, 2 * groups * 64 * (D + 8) * 4)]
    # Two groups: group 1's dk and dv sums, [8 warps][2 D / 8][32] float4,
    # reuse the tiles (one group stores its own from registers).
    if groups == 2:
        assert 8 * 2 * (D // 8) * 32 * 16 <= 2 * 2 * 2 * 64 * row
    for (a, sa), (b_, _) in zip(regions, regions[1:]):
        assert a % 16 == 0 and a + sa <= b_
    assert regions[-1][0] + regions[-1][1] <= plan.smem
    rows, keys, dq = _bwd_coverage(plan, B)
    assert (rows == 1).all() and (keys == 1).all() and (dq == 1).all()


def test_train_plan_at_the_v3_training_shape():
    """q [28, 345, 1280], k/v [28, 345, 256]: the forward's 2464 rounds
    (28 batches x 4 kv-heads x 22 16-row tiles, five q-heads of three
    128-key warps side by side: 15 warps) in spans of 19 over 130 CTAs; the
    backward clusters of three 16-warp CTAs, one per (kv-head, batch), 15
    steps of two 64-row tiles (G T = 30)."""
    plan = tat._train_plan(345, 20, 4, 64, 28, SMS)
    assert (plan.fwd.grid, plan.fwd.warps, plan.fwd.row_rounds,
            plan.fwd.span, plan.fwd.total, plan.fwd.resident) == \
        ((130, 1), 15, 22, 19, 2464, 1)
    assert (plan.grid, plan.cluster, plan.warps, plan.steps, plan.T) == \
        ((3, 4), 3, 16, 15, 6)


@pytest.mark.parametrize("N", [0, 769])
def test_train_plan_raises_outside_the_kernels(N):
    with pytest.raises(ValueError):
        tat._train_plan(N, 20, 4, 64, 28, SMS)


@pytest.mark.parametrize("D", [8, 48, 128, 136, 256])
def test_train_plan_raises_for_a_head_dim_without_a_kernel(D):
    """Head dims up to 128 run (8 and 48 zero-padded to the 16 and 64
    instances) and fit an sm_90 block; past 128 the plan is the wide
    kernels' (csrc/attention_wide.cu) at the next multiple of 128: the
    forward on the serving wide plan, the backward's dk/dv CTAs per
    (64 keys, kv-head, column group) and dq CTAs per (64 rows, q-head,
    column group), all in an sm_90 block."""
    if D > 128:
        plan = tat._train_plan(345, 20, 4, D, 28, SMS)
        assert isinstance(plan, tat.WideTrainPlan) and plan.D == 256
        assert plan.fwd.dp == 256 and plan.groups == 2 and plan.G == 5
        assert plan.dkdv_grid == (6, 8) and plan.dq_grid == (6, 40)
        assert max(plan.smem, plan.fwd.smem) <= SMEM_SM90
        return
    plan = tat._train_plan(345, 20, 4, D, 28, SMS)
    padded = next(p for p in (16, 32, 64, 128) if D <= p)
    assert plan.D == padded and plan == tat._train_plan(345, 20, 4, padded,
                                                        28, SMS)
    assert max(plan.smem, plan.fwd.smem) <= SMEM_SM90


def test_plans_take_every_n_the_jax_gates_admit():
    """Every preset's (q-heads, kv-heads, head dim), the JAX kernel tests'
    head dim 16 at tiny's heads, and head dim 128 at 4/2, 8/2 and 16/4
    heads: B15 and B16 (the JAX ``pallas`` and ``pallas2`` branches, which
    have no gate) at every N <= 2048, B2, B11 and B12 wherever JAX's
    ``flash_supported`` admits N, and B10 wherever ``train_flash_supported``
    does: each of the port's launch plans accepts it and fits an sm_90
    block.  (The gates admit N up to 976 at tiny, 864 at v1, 792 at v2,
    768 at v3, 1000 at head dim 16, and 864, 792 and 632 at head dim 128.)"""
    from jatsr_torch.configs import get_preset, list_presets
    from jatsr_torch.ops.attention import (NATURAL_MAX_N, _deferred_plan,
                                           _natural_plan)
    from jatsr_tpu.ops.attention import flash_supported

    geoms = {(m.num_q_heads, m.num_kv_heads, m.hidden_size // m.num_q_heads)
             for m in (get_preset(p).model for p in list_presets())}
    geoms.add((4, 2, 16))
    assert {d for _, _, d in geoms} == {16, 32, 64}
    geoms |= {(4, 2, 128), (8, 2, 128), (16, 4, 128)}
    top = {}
    for hq, hkv, D in sorted(geoms):
        for N in range(1, 2 * NATURAL_MAX_N + 1):
            plans = [_natural_plan(N, hq, hkv, D, grouped, 6, SMS)
                     for grouped in (False, True)]
            if flash_supported(N, hq, hkv, D):
                top[hq, hkv, D] = N
                plans += [_deferred_plan(N, hq, hkv, D, 6, SMS, n_valid, bal)
                          for n_valid in (None, N) for bal in (False, True)]
            if jat.train_flash_supported(N, hq, hkv, D):
                plan = tat._train_plan(N, hq, hkv, D, 28, SMS)
                plans += [plan.fwd, plan]
            assert all(p.smem <= SMEM_SM90 for p in plans), (hq, hkv, D, N)
    assert top == {(4, 2, 32): 976, (8, 4, 64): 864, (16, 4, 64): 792,
                   (20, 4, 64): 768, (12, 12, 64): 704, (4, 2, 16): 1000,
                   (4, 2, 128): 864, (8, 2, 128): 792, (16, 4, 128): 632}
