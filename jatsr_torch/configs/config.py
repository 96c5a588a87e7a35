"""Configuration for the PyTorch/CUDA port.

A field-for-field copy of the JAX package's config dataclasses and presets:
the port keeps its own copy so it never imports the JAX package, and
``tests/test_torch_imports.py`` holds every preset equal to the JAX one.
The port honours only the fields its ported branches read; a serving knob
that would select a branch the port does not have yet raises
``NotImplementedError`` where the model is built (``models/dit.py``).

==========  ===================================  ==========================
preset      model                                training specifics
==========  ===================================  ==========================
``v1``      DiT 512h/12L 8Q/4KV (~60 M)          MSE
``v2``      DiT 1024h/16L 16Q/4KV (~288 M)       MSE
``v3``      DiT 1280h/28L 20Q/4KV (~766 M)       MSE
``v3m2``    v3 + RMSNorm                         MSE + CFG dropout 0.1
``v3mod2``  v3 (LayerNorm)                       MSE + latent-perceptual
``v3mod3``  v3 (LayerNorm)                       Charbonnier + perceptual
==========  ===================================  ==========================

All presets share the DAC latent geometry: 1024 channels, x512 hop at
44.1 kHz, 16 s crops -> 1378 frames -> 345 patches of length 4.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """DiT architecture and its serving knobs."""

    input_channels: int = 1024
    cond_channels: int = 1024
    patch_len: int = 4
    hidden_size: int = 1280
    depth: int = 28
    num_q_heads: int = 20
    num_kv_heads: int = 4
    bottleneck_dim: int = 512
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    drop_path_rate: float = 0.05
    norm: str = "layer"  # "layer" (affine-free LayerNorm) | "rms"
    pos_embed: str = "rope"  # "rope" | "learned" (the v1-legacy model)
    attention_bias: bool = False  # q/k/v/out biases (v1-legacy only)
    rope_base: float = 10000.0
    rope_max_seq_len: int = 4096
    max_len: int = 2048  # max patch-sequence length
    dtype: str = "bfloat16"  # compute dtype; fp32 islands stay fp32
    param_dtype: str = "float32"
    # Serving attention: "xla" (einsum), "flash", "pallas", "pallas2".
    attention_impl: str = "xla"
    train_attention_impl: str = "flash"  # training attention: "flash" | "xla"
    scores_dtype: str = "float32"  # score storage on the einsum path
    # Projection precision: "bf16", "int8" (dynamic W8A8) or "int8_static"
    # (int8 kernels are the parameters, quantized once at load).
    matmul_precision: str = "bf16"
    quantize_head: bool = False  # int8 final_proj
    fused_mlp: bool = False  # dense + GELU + requant kernel for the MLP
    fused_mlp_impl: str = "half"  # "half" (first-half kernel) | "full"
    gelu_impl: str = "tanh"  # fused-kernel GELU: "tanh" | "erf" | "sigmoid"
    fast_epilogue: bool = True  # fp32 epilogue; False rounds y, g to bf16
    flash_qkv: bool = True  # flash kernel takes the unsplit fused QKV
    flash_fused_out: bool = False  # int8 out projection inside attention
    flash_int8_qk: bool = False  # int8 value product inside attention
    flash_pipeline_v: bool = False  # TPU scheduling only; same math
    align_n: bool = False  # pad the patch count to a multiple of 8
    int8_impl: str = "xla"  # dynamic W8A8 product: "xla" | "pallas" | "fused"
    fused_prologue: bool = False  # norm + modulate + quant inside the dots
    unroll_blocks: bool = False  # TPU compile knob; same math
    fused_qkv: bool = False  # one [H, (Hq + 2 Hkv) D] projection
    attn_valid_len: int = 0  # internal: real patch count under align_n
    remat_policy: str = "full"  # training: full | attn_out | mlp | dots | none

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_q_heads == 0
        return self.hidden_size // self.num_q_heads

    @property
    def num_groups(self) -> int:
        assert self.num_q_heads % self.num_kv_heads == 0
        return self.num_q_heads // self.num_kv_heads


@dataclass(frozen=True)
class LossConfig:
    """Training loss stack (the training slice reads it)."""

    reconstruction: str = "mse"  # "mse" | "charbonnier"
    charbonnier_eps: float = 1e-6
    reconstruction_weight: float = 1.0
    use_latent_perceptual: bool = False
    latent_loss_weight: float = 0.3
    freq_weight: float = 0.5
    ms_weight: float = 0.5
    consistency_weight: float = 0.1
    freq_loss_variant: str = "fixed"  # "fixed" | "buggy_v3mod1" (control)
    high_freq_weight: float = 2.0
    low_freq_phase_ratio: float = 0.3
    ms_scales: Tuple[int, ...] = (1, 2, 4)
    strict_cutoff: float = 0.30
    soft_cutoff: float = 0.36


@dataclass(frozen=True)
class DataConfig:
    """Data geometry and offline preprocessing."""

    data_dir: str = "data_processed"
    stats_file: str = "global_stats_separated.json"
    target_duration: float = 16.0
    dac_sample_rate: int = 44100
    dac_hop_length: int = 512
    samples_per_epoch_multiplier: int = 6
    high_sr: int = 48000
    low_sr: int = 16000
    chunk_duration: float = 7.0
    overlap_duration: float = 0.5
    min_duration: float = 1.0
    val_ratio: float = 0.1
    split_seed: int = 42
    chunking: str = "overlap"  # "overlap" | "plain" | "whole"

    @property
    def target_frames(self) -> int:
        return int(self.target_duration * self.dac_sample_rate
                   / self.dac_hop_length)


@dataclass(frozen=True)
class TrainConfig:
    """Training runtime (the training slice reads it)."""

    seed: int = 42
    batch_size: int = 28
    grad_accum_steps: int = 1
    lr: float = 5e-5
    weight_decay: float = 0.1
    warmup_steps: int = 1000
    num_epochs: int = 300
    grad_clip: float = 1.0
    condition_noise_ratio: float = 0.05
    use_adaptive_noise: bool = True
    cfg_dropout_prob: float = 0.0
    timestep_alpha: float = 0.5
    save_dir_base: str = "checkpoints"
    log_dir_base: str = "runs"
    save_interval_steps: int = 1000
    keep_interval_checkpoints: int = 3
    save_last_every_epochs: int = 1
    save_best_every_epochs: int = 1
    log_interval_steps: int = 10
    mesh_shape: Tuple[int, int] = (1, 1)
    remat: bool = True
    adam_moments_dtype: str = "float32"
    shard_opt_state: bool = False
    prng_impl: str = "rbg"


@dataclass(frozen=True)
class SamplerConfig:
    """Flow-matching Euler ODE sampling and chunked inference."""

    num_steps: int = 50
    cfg_scale: float = 1.0
    solver: str = "euler"  # "euler" | "heun"
    t_jump_threshold: float = 0.999  # jump to x0 at t >= this
    velocity_eps: float = 1e-5  # 1 / (1 - t + eps) guard
    # Guidance interval (fractions of the schedule): CFG only for t in
    # [lo, hi); outside, the conditional branch alone drives the ODE.
    cfg_interval: Tuple[float, float] = (0.0, 1.0)
    cfg_batching: str = "doubled"  # one 2B forward | "split": two B forwards
    chunk_duration: float = 16.0
    overlap_duration: float = 2.0
    chunk_noise: str = "per_chunk"  # "per_chunk" | "batch" (one per group)
    pad_tail_group: bool = False  # pad a short tail group to max_batch


@dataclass(frozen=True)
class Preset:
    name: str
    model: ModelConfig
    loss: LossConfig
    train: TrainConfig
    data: DataConfig = field(default_factory=DataConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Preset":
        """Rebuild a preset from :meth:`to_json` output (the ``preset.json``
        of a run directory, the JAX package's too)."""
        d = json.loads(s)
        return cls(
            name=d["name"],
            model=ModelConfig(**{**d["model"],
                                 "rope_base": float(d["model"]["rope_base"])}),
            loss=LossConfig(**{**d["loss"],
                               "ms_scales": tuple(d["loss"]["ms_scales"])}),
            train=TrainConfig(**{**d["train"], "mesh_shape": tuple(
                d["train"]["mesh_shape"])}),
            data=DataConfig(**d["data"]),
            sampler=SamplerConfig(**{**d["sampler"], "cfg_interval": tuple(
                d["sampler"].get("cfg_interval", (0.0, 1.0)))}))


def _mk(name, model_kw, loss_kw, train_kw) -> Preset:
    return Preset(name=name, model=ModelConfig(**model_kw),
                  loss=LossConfig(**loss_kw), train=TrainConfig(**train_kw))


_V3_MODEL = dict(hidden_size=1280, depth=28, num_q_heads=20, num_kv_heads=4)

_PRESETS = {
    # Legacy v1 architecture: plain MHA with biases, learned positions.
    "v1legacy": _mk(
        "v1legacy",
        dict(hidden_size=768, depth=12, num_q_heads=12, num_kv_heads=12,
             bottleneck_dim=128, pos_embed="learned", attention_bias=True,
             dropout=0.0, drop_path_rate=0.0),
        dict(reconstruction="mse"),
        dict(),
    ),
    "v1": _mk(
        "v1",
        dict(hidden_size=512, depth=12, num_q_heads=8, num_kv_heads=4,
             drop_path_rate=0.0),
        dict(reconstruction="mse"),
        dict(),
    ),
    "v2": _mk(
        "v2",
        dict(hidden_size=1024, depth=16, num_q_heads=16, num_kv_heads=4,
             drop_path_rate=0.0),
        dict(reconstruction="mse"),
        dict(),
    ),
    "v2full": _mk(
        "v2full",
        dict(hidden_size=1024, depth=16, num_q_heads=16, num_kv_heads=4,
             dropout=0.1, drop_path_rate=0.0),
        dict(reconstruction="mse"),
        dict(batch_size=72, lr=5e-5, warmup_steps=1000, num_epochs=1000),
    ),
    "v3": _mk("v3", dict(**_V3_MODEL), dict(reconstruction="mse"), dict()),
    "v3m2": _mk(
        "v3m2",
        dict(**_V3_MODEL, norm="rms"),
        dict(reconstruction="mse"),
        dict(cfg_dropout_prob=0.1, condition_noise_ratio=0.02),
    ),
    # Negative control: the historical frequency loss with artifacts.
    "v3mod1": _mk(
        "v3mod1",
        dict(**_V3_MODEL),
        dict(reconstruction="mse", use_latent_perceptual=True,
             freq_loss_variant="buggy_v3mod1", consistency_weight=0.0),
        dict(),
    ),
    "v3mod2": _mk(
        "v3mod2",
        dict(**_V3_MODEL),
        dict(reconstruction="mse", use_latent_perceptual=True),
        dict(),
    ),
    "v3mod3": _mk(
        "v3mod3",
        dict(**_V3_MODEL),
        dict(reconstruction="charbonnier", use_latent_perceptual=True),
        dict(),
    ),
    "v3m2mod1": _mk(
        "v3m2mod1",
        dict(**_V3_MODEL, norm="rms"),
        dict(reconstruction="charbonnier"),
        dict(cfg_dropout_prob=0.1, condition_noise_ratio=0.02),
    ),
    # Tiny config for tests.
    "tiny": _mk(
        "tiny",
        dict(hidden_size=128, depth=2, num_q_heads=4, num_kv_heads=2,
             bottleneck_dim=64, dropout=0.0, drop_path_rate=0.0),
        dict(reconstruction="mse"),
        dict(batch_size=2, warmup_steps=10),
    ),
}


def get_preset(name: str) -> Preset:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(_PRESETS)}")


def list_presets():
    return sorted(_PRESETS)
