"""B2's int8 value product (``gqa_attention_flash_qkv(..., int8_qk=True)``,
the JAX package's flash v3.4) and the attention launch plans at G = 1, on
the CPU.

The port's plain version (what the wrapper runs on a CPU tensor) against
the JAX kernel in interpret mode, on the same bf16 qkv: the scores stay
bf16 x bf16 -> fp32 in base 2, e = exp2(s - m) unrounded, w = round(e *
127), v quantised per (batch, kv-head, column) over all the rows the
kernel's block holds, the rows between n_valid and N too (align_n's
padded patches: masked as keys only), and o = (acc * (r / 127)) * sv.
Where an e sits on a rounding boundary of e * 127, the two frameworks'
exp2 (one fp32 ulp apart) can flip its code by one: one bf16 ulp of an
output at most.  Tolerance: atol = rtol = 1e-2 (the outputs' magnitude is
~1.5; measured: bit-equal at D <= 64, max 4.9e-4 at D 128 and 3.9e-3 at
D 256 on 0.004 % and 0.4 % of the outputs).

``v_codes_plain`` (the layout of the card's codes) holds each 32-key
block in ``kperm`` order: unpermuted, it is round(v / sv).

The launch plans (``_deferred_plan``, ``_natural_plan``) at v1legacy's
heads (12 q-heads, 12 kv-heads: one q-head per kv-head) and its serving
shape, batch 6 and N 345: shared memory, warps, and each (batch, row,
q-head) covered once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dit import rope_cos_sin
from jatsr_tpu.ops.attention import gqa_attention_flash_qkv as jax_flash_qkv
from jatsr_torch.ops.attention import (_deferred_plan, _natural_plan,
                                       gqa_attention_flash_qkv, kperm,
                                       v_codes_plain)

from test_torch_attention_deferred import SMS, _check_layout

B, N, HQ, HKV = 2, 40, 4, 2
N_VALID = 37


def _qkv(seed, D):
    """bf16 qkv [B, N, (HQ + 2 HKV) D] (as numpy fp32 and jnp bf16) whose
    padded row N_VALID + 1 holds every v column's absmax."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, (HQ + 2 * HKV) * D)).astype(np.float32)
    x[:, N_VALID + 1, (HQ + HKV) * D:] = 5.0
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return np.asarray(xb.astype(jnp.float32)), xb


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("n_valid", [N_VALID, 0])
def test_int8_qk_plain_matches_jax_interpret(D, n_valid):
    x, xb = _qkv(D, D)
    cos, sin = rope_cos_sin(N, D)
    want = np.asarray(jax_flash_qkv(xb, cos, sin, HQ, HKV, interpret=True,
                                    n_valid=n_valid, int8_qk=True),
                      np.float32)
    got = gqa_attention_flash_qkv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(np.asarray(cos)),
        torch.from_numpy(np.asarray(sin)), HQ, HKV, n_valid=n_valid,
        int8_qk=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, HQ * D)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=1e-2)


def test_padded_rows_set_the_value_scale():
    """The row past n_valid that holds every column's max decides sv: the
    output differs from the one on the same qkv with that row zeroed
    (masked as a key either way), on both sides alike."""
    D = 32
    x, xb = _qkv(3, D)
    cos, sin = rope_cos_sin(N, D)
    zeroed = x.copy()
    zeroed[:, N_VALID + 1] = 0.0
    outs = []
    for arr in (x, zeroed):
        t = gqa_attention_flash_qkv(
            torch.from_numpy(arr).bfloat16(),
            torch.from_numpy(np.asarray(cos)),
            torch.from_numpy(np.asarray(sin)), HQ, HKV, n_valid=N_VALID,
            int8_qk=True).float().numpy()
        j = np.asarray(jax_flash_qkv(jnp.asarray(arr).astype(jnp.bfloat16),
                                     cos, sin, HQ, HKV, interpret=True,
                                     n_valid=N_VALID, int8_qk=True),
                       np.float32)
        np.testing.assert_allclose(t, j, atol=1e-2, rtol=1e-2)
        outs.append(t)
    assert np.abs(outs[0] - outs[1]).max() > 1e-2


def test_v_codes_layout_is_kperm_of_the_codes():
    D, nk = 32, 128
    x, _ = _qkv(4, D)
    v = torch.from_numpy(x[..., (HQ + HKV) * D:]).bfloat16()
    codes, sv = v_codes_plain(v, HKV, nk)
    assert codes.shape == (B, HKV, D, nk) and codes.dtype == torch.int8
    vf = v.float().reshape(B, N, HKV, D)
    want_sv = torch.clamp_min(vf.abs().amax(dim=1) * np.float32(1 / 127),
                              1e-12)
    torch.testing.assert_close(sv, want_sv, atol=0, rtol=0)
    inverse = torch.empty(nk, dtype=torch.long)
    for pos in range(nk):
        inverse[(pos // 32) * 32 + kperm(pos % 32)] = pos
    assert sorted(inverse.tolist()) == list(range(nk))  # a permutation
    keys = codes[..., inverse][..., :N].permute(0, 3, 1, 2)  # [B, N, hkv, D]
    torch.testing.assert_close(keys.float(),
                               torch.round(vf / want_sv[:, None]),
                               atol=0, rtol=0)
    assert not codes[..., inverse][..., N:].any()


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("n_valid", [345, None])
def test_deferred_plan_at_one_group(n_valid, balanced):
    """B2/B11 at v1legacy's 12/12 heads, head dim 64, [6, 345]: one q-head
    a CTA round (W = 3 warps of 128 keys), K and V resident."""
    plan = _deferred_plan(345, 12, 12, 64, 6, SMS, n_valid, balanced)
    assert (plan.heads, plan.hc, plan.W, plan.warps) == (1, 1, 3, 3)
    assert plan.resident
    _check_layout(plan, 6, 64)


@pytest.mark.parametrize("grouped", [False, True])
def test_natural_plan_at_one_group(grouped):
    """B15 and B16 at v1legacy's heads: one grid (a q-head is a kv-head)."""
    plan = _natural_plan(345, 12, 12, 64, grouped, 6, SMS)
    assert plan.heads == 1
    _check_layout(plan, 6, 64)
    assert plan.launch_grid(6)[1] == 12
