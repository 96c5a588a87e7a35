"""The launch plan of the base-2 flash attention kernels B2 and B11
(``csrc/attention_deferred.cu``) and of B12's attention (``csrc/flash_qkv.cu``,
B2's plan), checked where no card exists.

``_deferred_plan`` is pure Python: B16's per-kv-head layout of
``_natural_plan`` on its own grid or the balanced one, with the key mask
limit and the zero keys of B11.  For every N the kernels take, each grid,
batch 1 and 6, G 1, 2 and 5 and head dims 16, 32 and 64, its shared memory
must fit an sm_90 block,
its CTA must launch, its shared-memory regions must not overlap, its
rounds must cover every (batch, query row, q-head) exactly once, and its
limit must be B2's n_valid or B11's N rounded up to 8 (npad the zero keys
between).  The enumeration follows the kernel's own indexing: round rd of
CTA (x, y, b) takes tile ``x * row_rounds + rd // head_rounds`` of batch b
and kv-head y; on the balanced grid round rd of CTA x is f = x * span + rd
of the flattened list, (batch, y) = divmod(f // per_y, ny), tile and head
round = divmod(f % per_y, head_rounds).  A round covers rows tile * rows +
(pair % R) * 16 + [0, 16) of q-head y * heads + hr * hc + pair // R.
"""

import numpy as np
import pytest

from jatsr_torch.ops.attention import (NATURAL_MAX_N, _deferred_plan,
                                       _natural_plan)

SMEM_SM90 = 232_448     # an sm_90 block's opt-in shared memory
SMS = 132               # an H100 SXM's SMs


def row_bytes(D):
    """Bytes of a D-wide bf16 row plus its 8 pad."""
    return 2 * D + 16


def _rounds(plan, B):
    """Every (batch, kv-head y, tile, head round) a CTA takes, one row
    each: [rounds, 4]."""
    per_y = plan.row_rounds * plan.head_rounds
    ny = plan.hq // plan.heads
    if plan.span:  # balanced: CTA x takes rounds x * span .. of the list
        assert plan.grid[1] == 1 and plan.total == B * ny * per_y
        assert plan.launch_grid(B) == (plan.grid[0], 1, 1)
        x = np.arange(plan.grid[0])
        n = np.minimum(plan.span, plan.total - x * plan.span)
        assert (n > 0).all()
        f = np.concatenate([x0 * plan.span + np.arange(k)
                            for x0, k in zip(x, n)])
        by, rr = np.divmod(f, per_y)
        b, y = np.divmod(by, ny)
    else:          # the grid's own (x, y, batch), row_rounds tiles a CTA
        assert plan.grid[1] == ny and plan.launch_grid(B) == (*plan.grid, B)
        x, y, b, rd = (a.ravel() for a in np.meshgrid(
            np.arange(plan.grid[0]), np.arange(ny), np.arange(B),
            np.arange(per_y), indexing="ij"))
        rr = (x * plan.row_rounds * plan.head_rounds) + rd
    tile, hr = np.divmod(rr, plan.head_rounds)
    return np.stack([b, y, tile, hr], axis=1)


def _coverage(plan, B):
    """How often each (batch, row, q-head) is computed and stored."""
    count = np.zeros((B, plan.N, plan.hq), np.int64)
    R = plan.rows // 16
    rounds = _rounds(plan, B)
    for pair in range(plan.warps // plan.W):
        slot = rounds[:, 3] * plan.hc + pair // R
        keep = slot < plan.heads
        b, y, tile = (rounds[keep, i] for i in range(3))
        rows = (tile * plan.rows + (pair % R) * 16)[:, None] + np.arange(16)
        head = np.broadcast_to((y * plan.heads + slot[keep])[:, None],
                               rows.shape)
        bb = np.broadcast_to(b[:, None], rows.shape)
        ok = rows < plan.N
        np.add.at(count, (bb[ok], rows[ok], head[ok]), 1)
    return count


def _check_layout(plan, B, D):
    assert plan.smem <= SMEM_SM90
    # the kernels' launch bounds: 16 warps, 8 at D = 128 and streaming
    assert plan.warps <= (8 if D == 128 or plan.stream else 16)
    assert plan.nk >= plan.N and plan.nk % 128 == 0
    assert plan.W * (plan.rows // 16) * plan.hc == plan.warps
    hr = plan.head_rounds
    assert hr * plan.hc >= plan.heads > (hr - 1) * plan.hc
    if plan.stream:  # K's and V's two 128-key chunk buffers, the q rows
        assert plan.W == 1 and plan.row_rounds == 1 and not plan.span
        chunk = 128 * row_bytes(D)
        spans = sorted([(plan.k_off, 2 * chunk), (plan.v_off, 2 * chunk),
                        (plan.q_off, plan.warps * 16 * row_bytes(D))])
        for (a, sa), (b, _) in zip(spans, spans[1:]):
            assert a + sa <= b, spans
        assert spans[-1][0] + spans[-1][1] <= plan.smem
        assert (_coverage(plan, B) == 1).all()
        return
    assert plan.nk == 128 * plan.W
    pairs = plan.warps // plan.W
    kv = plan.nk * row_bytes(D)
    regions = [(plan.k_off, kv), (plan.q_off, pairs * 16 * row_bytes(D)),
               (plan.red_off, 2 * pairs * plan.W * 16 * 4)]
    if plan.resident:
        regions.append((plan.v_off, kv))
    else:  # V takes K's buffer; K is reloaded each round
        assert plan.v_off == plan.k_off
        assert plan.row_rounds == 1 or plan.span
    part = pairs * plan.W * (D // 8) * 32 * 16 if plan.W > 1 else 0
    if part and plan.part_off != plan.k_off:
        regions.append((plan.part_off, part))
    elif part:  # K's buffer, once K is dead for good
        assert plan.row_rounds == hr == 1 and plan.resident
    for off, size in regions:
        assert off % 16 == 0 and off + size <= plan.smem
    spans = sorted(regions)
    for (a, sa), (b, _) in zip(spans, spans[1:]):
        assert a + sa <= b, spans
    assert (_coverage(plan, B) == 1).all()


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("B", [1, 6])
@pytest.mark.parametrize("G", [1, 2, 5])
def test_deferred_plan_fits_and_covers_every_row_and_head_once(G, B,
                                                               balanced, D):
    """B2 and B12 (keys masked at n_valid: N and N - 7) and B11 (zero keys
    up to round_up(N, 8)) at every N in [1, 1024]: one layout, its own
    limit (at D = 128 past 640 keys the streaming mode's, on its own
    grid)."""
    hkv = 2
    for N in range(1, NATURAL_MAX_N + 1):
        split = _deferred_plan(N, G * hkv, hkv, D, B, SMS, None, balanced)
        np_ = -(-N // 8) * 8
        assert (split.limit, split.npad) == (np_, np_ - N), N
        assert split.limit <= split.nk, N
        for n_valid in {N, max(1, N - 7)}:
            qkv = _deferred_plan(N, G * hkv, hkv, D, B, SMS, n_valid,
                                 balanced)
            assert vars(qkv) == {**vars(split), "limit": n_valid,
                                 "npad": 0}, N
        assert split.stream == (D == 128 and N > 640), N
        assert split.heads == G, N
        assert bool(split.span) == (balanced and not split.stream), N
        try:
            _check_layout(split, B, D)
        except AssertionError as e:
            raise AssertionError(f"N={N}") from e


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("n_valid", [345, None])
def test_deferred_plan_at_the_serving_shape(n_valid, balanced):
    """B2 on qkv [6, 352, 1792] with keys masked past 345, B11 on q
    [6, 345, 1280], k/v [6, 345, 256]: three warps of 128 keys a row
    group, five q-heads side by side (15 warps), K and V resident; 22
    16-row tiles a (batch, kv-head); 120 CTAs of 5 rounds on the
    per-kv-head grid, or the 528 rounds in spans of 4 over 132 CTAs."""
    N = 352 if n_valid else 345
    plan = _deferred_plan(N, 20, 4, 64, 6, SMS, n_valid, balanced)
    assert (plan.N, plan.nk, plan.hq, plan.hkv, plan.rows, plan.W,
            plan.heads, plan.hc, plan.head_rounds, plan.resident,
            plan.warps) == (N, 384, 20, 4, 16, 3, 5, 5, 1, 1, 15)
    assert (plan.k_off, plan.v_off, plan.q_off, plan.red_off,
            plan.part_off, plan.smem) == (0, 55296, 110592, 122112, 124032,
                                          185472)
    assert (plan.limit, plan.npad) == ((345, 0) if n_valid else (352, 7))
    if balanced:
        assert (plan.row_rounds, plan.span, plan.total, plan.grid) == (
            22, 4, 528, (132, 1))
    else:
        assert (plan.row_rounds, plan.span, plan.total, plan.grid) == (
            5, 0, 0, (5, 4))
    # The natural plan of the same layout differs only in the limit.
    natural = _natural_plan(N, 20, 4, 64, True, 6, SMS, balanced=balanced)
    assert (natural.limit, natural.npad) == (N, 0)
    assert vars(natural) == {**vars(plan), "limit": N, "npad": 0}


@pytest.mark.parametrize("N,n_valid", [(0, None), (NATURAL_MAX_N + 1, None),
                                       (NATURAL_MAX_N + 1, 1), (10, 11),
                                       (10, 0)])
def test_deferred_plan_raises_outside_the_kernels(N, n_valid):
    for balanced in (False, True):
        with pytest.raises(ValueError):
            _deferred_plan(N, 20, 4, 64, 6, SMS, n_valid, balanced)
