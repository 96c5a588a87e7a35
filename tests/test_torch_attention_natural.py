"""The launch plan of the per-q-head and per-kv-head attention kernel
(``csrc/attention_natural.cu``), checked where no card exists.

``_natural_plan`` is pure Python: for every N up to 2048 (past 1024, and
at head dim 128 past 640, the streaming mode), each head dim it is built
for (16, 32, 64, 128) and each grid, its shared memory must fit an sm_90
block, its CTA must launch, its
shared-memory regions must not overlap where they are live together, and
its CTAs, rounds and warps must cover every (query row, q-head) exactly
once.  The enumeration below follows the kernel's own indexing: in round
rd, CTA (x, y) covers rows ``tile * rows + (pair % R) * 16 + [0, 16)`` of
q-head ``y * heads + (rd % head_rounds) * hc + pair // R``, for ``tile = x *
row_rounds + rd // head_rounds`` and ``R = rows // 16``, where that head
slot is below ``heads``.
"""

import numpy as np
import pytest

from jatsr_torch.ops.attention import (NATURAL_MAX_N, WidePlan,
                                       _deferred_plan, _natural_plan)

STREAM_N = 2048         # the largest N the plan tests walk

SMEM_SM90 = 232_448     # an sm_90 block's opt-in shared memory
SMS = 132               # an H100 SXM's SMs


def row_bytes(D):
    """Bytes of a D-wide bf16 row plus its 8 pad."""
    return 2 * D + 16


def _coverage(plan):
    """How often each (row, q-head) is computed and stored: [N, hq]."""
    count = np.zeros((plan.N, plan.hq), np.int64)
    R = plan.rows // 16
    pairs = plan.warps // plan.W
    xs, ys = np.arange(plan.grid[0]), np.arange(plan.grid[1])
    for rd in range(plan.row_rounds * plan.head_rounds):
        tiles = xs * plan.row_rounds + rd // plan.head_rounds
        for pair in range(pairs):
            slot = (rd % plan.head_rounds) * plan.hc + pair // R
            if slot >= plan.heads:
                continue
            rows = (tiles[:, None] * plan.rows + (pair % R) * 16
                    + np.arange(16)[None, :]).ravel()
            rows = rows[rows < plan.N]
            np.add.at(count, (rows[:, None], (ys * plan.heads + slot)[None]),
                      1)
    return count


def _regions(plan, D):
    """The live shared-memory regions (offset, bytes) of one round."""
    if plan.stream:  # K's and V's two chunk buffers, the warps' q rows
        chunk = 128 * row_bytes(D)
        return [(plan.k_off, 2 * chunk), (plan.v_off, 2 * chunk),
                (plan.q_off, plan.warps * 16 * row_bytes(D))], 0
    pairs = plan.warps // plan.W
    kv = plan.nk * row_bytes(D)
    out = [(plan.k_off, kv), (plan.q_off, pairs * 16 * row_bytes(D)),
           (plan.red_off, 2 * pairs * plan.W * 16 * 4)]
    if plan.resident:
        out.append((plan.v_off, kv))
    part = pairs * plan.W * (D // 8) * 32 * 16 if plan.W > 1 else 0
    if part and plan.part_off != plan.k_off:
        out.append((plan.part_off, part))
    return out, part


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("B", [1, 6])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("G", [1, 2, 4, 5])
def test_natural_plan_fits_and_covers_every_row_and_head_once(G, grouped, B,
                                                              D):
    hkv = 2
    for N in range(1, STREAM_N + 1):
        plan = _natural_plan(N, G * hkv, hkv, D, grouped, B, SMS)
        assert plan.smem <= SMEM_SM90, N
        # the kernels' launch bounds: 16 warps, 8 at D = 128 and streaming
        assert plan.warps <= (8 if D == 128 or plan.stream else 16), N
        assert plan.stream == (N > NATURAL_MAX_N or (D == 128 and N > 640)), N
        assert plan.nk >= N and plan.nk % 128 == 0, N
        assert plan.stream or plan.nk == 128 * plan.W, N
        assert plan.W * (plan.rows // 16) * plan.hc == plan.warps, N
        hr = plan.head_rounds
        assert hr * plan.hc >= plan.heads > (hr - 1) * plan.hc, N
        assert plan.row_rounds == 1 or plan.resident, N
        regions, part = _regions(plan, D)
        for off, size in regions:
            assert off % 16 == 0 and off + size <= plan.smem, (N, off)
        spans = sorted(regions)
        for (a, sa), (b, _) in zip(spans, spans[1:]):
            assert a + sa <= b, (N, spans)
        if part and plan.part_off == plan.k_off:
            # The partial outputs take K's buffer only once K is dead for
            # good: one round, V in a buffer of its own.
            assert plan.row_rounds == hr == 1 and plan.resident
            assert part <= plan.nk * row_bytes(D)
        if not plan.resident and not plan.stream:
            assert plan.v_off == plan.k_off
        cover = _coverage(plan)
        assert (cover == 1).all(), (N, np.argwhere(cover != 1)[:4])


@pytest.mark.parametrize("grouped", [False, True])
def test_natural_plan_at_the_serving_shape(grouped):
    """q [6, 345, 20, 64], k/v [6, 345, 4, 64]: three warps of 128 keys a
    row group, K and V resident, 120 CTAs on the 132 SMs; B15 a CTA per
    q-head taking its six 64-row tiles in turn, B16 a CTA per fifth of a
    kv-head's 16-row tiles (five in turn) with its five q-heads side by
    side."""
    plan = _natural_plan(345, 20, 4, 64, grouped, 6, SMS)
    assert (plan.nk, plan.W, plan.head_rounds, plan.resident) == (384, 3, 1,
                                                                  1)
    if grouped:
        assert (plan.rows, plan.hc, plan.warps, plan.row_rounds,
                plan.grid) == (16, 5, 15, 5, (5, 4))
    else:
        assert (plan.rows, plan.hc, plan.warps, plan.row_rounds,
                plan.grid) == (64, 1, 12, 6, (1, 20))


@pytest.mark.parametrize("N", [0, NATURAL_MAX_N + 1])
def test_natural_plan_raises_outside_the_kernel(N):
    """N = 0 raises.  Past ``NATURAL_MAX_N`` the kernel has no edge any
    more: N = 1025 (which raised before the streaming mode) takes that mode,
    nine 128-key chunks through shared memory, on both grids."""
    for grouped in (False, True):
        if N < 1:
            with pytest.raises(ValueError):
                _natural_plan(N, 20, 4, 64, grouped, 6, SMS)
            continue
        plan = _natural_plan(N, 20, 4, 64, grouped, 6, SMS)
        assert plan.stream == 1 and plan.nk == 9 * 128
        assert plan.smem <= SMEM_SM90 and plan.warps <= 8
        assert plan.grid == ((-(-N // 16) if grouped else -(-N // 128)),
                             4 if grouped else 20)


@pytest.mark.parametrize("D", [8, 48, 128, 136, 256])
def test_natural_plan_raises_for_a_head_dim_without_a_kernel(D):
    """Head dims up to 128 run (8 and 48 zero-padded to the 16 and 64
    instances, 128 its own) and fit an sm_90 block on both grids; past 128
    (where a head's fp32 output row would outgrow the attention body's
    registers) the plan is the wide kernels' at the next multiple of 128,
    one plan for both grids, which fits an sm_90 block too."""
    for grouped in (False, True):
        if D > 128:
            plan = _natural_plan(345, 20, 4, D, grouped, 6, SMS)
            assert isinstance(plan, WidePlan) and plan.dp == 256
            assert plan.smem <= SMEM_SM90 and plan.warps == 4
            assert plan == _natural_plan(345, 20, 4, 256, not grouped, 6,
                                         SMS)
            continue
        plan = _natural_plan(345, 20, 4, D, grouped, 6, SMS)
        padded = next(p for p in (16, 32, 64, 128) if D <= p)
        assert plan.smem <= SMEM_SM90 and not plan.stream
        assert plan == _natural_plan(345, 20, 4, padded, grouped, 6, SMS)


@pytest.mark.parametrize("grouped", [False, True])
def test_natural_plan_past_768_keys_at_head_dim_64(grouped):
    """N = 1000 at v3's heads: eight chunks of 128 keys a row group, two
    row groups (16 warps) a CTA; K and V (144 KB each at D = 64) no longer
    fit together, so V takes K's buffer and each CTA takes one row tile; at
    D = 32 they fit again."""
    plan = _natural_plan(1000, 20, 4, 64, grouped, 6, SMS)
    assert (plan.nk, plan.W, plan.resident, plan.row_rounds) == (1024, 8, 0,
                                                                 1)
    assert plan.v_off == plan.k_off == 0 and plan.warps == 16
    assert _natural_plan(1000, 20, 4, 32, grouped, 6, SMS).resident == 1


@pytest.mark.parametrize("D", [136, 192, 256, 384])
@pytest.mark.parametrize("G", [1, 5])
def test_wide_plans_fit_and_cover_every_row_head_and_group_once(G, D):
    """Past head dim 128 (csrc/attention_wide.cu): B15's and B16's plan,
    B2's and B11's (keys masked at n_valid, or N padded with zero keys to a
    multiple of 8 whose share comes off l), at N up to 1100: 4-warp CTAs
    in an sm_90 block, the keys in 128-key chunks, and CTA (x, y) covering
    rows ``64 x + [0, 64)`` of q-head ``y // groups`` in output column
    group ``y % groups``, each (row, q-head, group) once."""
    hkv = 2
    hq = G * hkv
    dp = -(-D // 128) * 128
    for N in list(range(1, 300)) + [345, 640, 1000, 1024, 1100]:
        plan = _natural_plan(N, hq, hkv, D, True, 6, SMS)
        assert isinstance(plan, WidePlan)
        assert (plan.dp, plan.groups, plan.warps) == (dp, dp // 128, 4)
        assert plan.smem <= SMEM_SM90 and plan.nk >= N and plan.nk % 128 == 0
        assert (plan.limit, plan.npad) == (N, 0)
        x, y = np.meshgrid(np.arange(plan.grid[0]), np.arange(plan.grid[1]),
                           indexing="ij")
        count = np.zeros((N, hq, plan.groups), np.int64)
        rows = x[..., None] * plan.rows + np.arange(plan.rows)
        heads = np.broadcast_to((y // plan.groups)[..., None], rows.shape)
        groups = np.broadcast_to((y % plan.groups)[..., None], rows.shape)
        keep = rows < N
        np.add.at(count, (rows[keep], heads[keep], groups[keep]), 1)
        assert (count == 1).all(), N
        if N <= NATURAL_MAX_N:
            b11 = _deferred_plan(N, hq, hkv, D, 6, SMS, None, True)
            assert (b11.limit, b11.npad) == (-(-N // 8) * 8, -N % 8)
            b2 = _deferred_plan(N, hq, hkv, D, 6, SMS, max(1, N - 3), False)
            assert (b2.limit, b2.npad, b2.grid) == (max(1, N - 3), 0,
                                                    plan.grid)
