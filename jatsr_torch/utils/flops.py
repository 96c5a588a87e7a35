"""Analytic model FLOPs for MFU on the card.

A copy of the JAX package's ``utils/flops.py`` counts (multiply-accumulate
= 2 FLOPs; elementwise and softmax work ignored).  MFU here is against the
H100's dense bf16 tensor-core peak, never a TPU's.
"""

from __future__ import annotations

# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet, 700 W).
H100_BF16_PEAK_FLOPS = 989e12

# Training-step multiplier over one forward: backward is 2x forward;
# rematerialisation replays some of the forward again during backward.
TRAIN_FLOP_FACTOR = {"none": 3.0, "dots": 3.5, "attn_out": 3.9, "full": 4.0}


def dit_forward_flops(cfg, batch: int, frames: int) -> float:
    """Matmul FLOPs of ONE DiT forward at [batch, frames, C] inputs."""
    P = cfg.patch_len
    N = -(-frames // P)  # patch count after pad
    H = cfg.hidden_size
    D = cfg.head_dim
    Hq, Hkv = cfg.num_q_heads, cfg.num_kv_heads
    Cin = cfg.input_channels + cfg.cond_channels
    mlp = int(H * cfg.mlp_ratio)

    per_token_block = (
        2 * H * (Hq + 2 * Hkv) * D      # q/k/v projections (fused or not)
        + 2 * H * H                     # out_proj
        + 2 * H * mlp * 2               # mlp_in + mlp_out
    )
    per_block_attn = 2 * N * N * D * Hq * 2       # scores + values
    per_block = N * per_token_block + per_block_attn + 2 * H * 6 * H  # +adaln
    embed = N * (2 * P * Cin * cfg.bottleneck_dim
                 + 2 * cfg.bottleneck_dim * H)
    head = N * 2 * H * (P * cfg.input_channels)
    t_emb = 2 * H * H * 2
    return float(batch) * (embed + cfg.depth * per_block + head + t_emb)


def train_step_flops(cfg, batch: int, frames: int,
                     grad_accum: int = 1) -> float:
    """Model FLOPs of one optimizer step (fwd + bwd + remat replay)."""
    factor = TRAIN_FLOP_FACTOR.get(cfg.remat_policy, 4.0)
    return dit_forward_flops(cfg, batch, frames) * factor * max(grad_accum, 1)


def mfu(flops_per_step: float, sec_per_step: float,
        peak: float = H100_BF16_PEAK_FLOPS) -> float:
    return flops_per_step / sec_per_step / peak
