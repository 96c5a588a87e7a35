#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from ``jatsr_torch/ops/csrc/``, holds each
against its plain PyTorch version at the serving paths' own shapes (and
times kernel, plain version and a PyTorch library call as a yardstick),
then drives the port's eighteen serving paths end to end at full width,
each once with its launches counted and (but three short ones) then timed:
the v3 766 M int8 DiT (random weights from a seed, quantized by the port)
through the Euler CFG sampler over ~44 s of latent, then the segmented DAC
decode (two 2884-frame segments, random weights from a seed).

- The main path is ``bench.py``'s default end to end: the fused prologue
  with ``align_n`` (352 patches per chunk, keys masked past 345), where
  each block runs norm_mod_dot (qkv), flash_qkv, matmul_fused (out_proj)
  and norm_mod_dense_gelu_quant (mlp_in) and the patch embed runs
  dense_gelu_quant; then the fused decode (``fused_res_units``): per
  segment snake_conv_transpose_streamed at stage 0,
  snake_conv_transpose_fused and res_stage_fused at stages 1-3.
- The second path is ``bench.py --no-fused-prologue --no-fused-decode``
  (345 patches): flash_qkv and dense_gelu_quant (patch embed and mlp_in),
  then the unfused fp32 decode (cuDNN convolutions, TF32 off).
- The third path is ``bench.py --flash-out --fused-mlp-impl full
  --int8-impl pallas`` (352 patches, keys masked past 345; the fused
  prologue is off there, as in the JAX model): each block runs
  int8_matmul (the qkv product, behind w8a8_dot's row-quant launch),
  flash_out (attention with the int8 out projection) and int8_mlp (the
  whole MLP);
  the patch embed runs dense_gelu_quant; then the fused decode.
- The fourth, fifth and sixth paths are ``bench.py --no-flash-qkv``,
  ``--attention pallas`` and ``--attention pallas2`` (the fused prologue
  and align_n asked for; the JAX model takes neither without the flash-QKV
  branch, so 345 patches): each block splits the qkv projection, applies
  RoPE in bf16 and runs flash_split, gqa_attention or
  gqa_attention_grouped; the patch embed and every mlp_in run
  dense_gelu_quant; then the fused decode.
- ``int8_cli``: the DiT as the JAX CLI's ``--int8 --quantize-head``
  builds it (fused q/k/v, the unfused QuantDense MLP, the int8 head, the
  einsum attention with fp32 scores, ``int8_impl="xla"``): no kernel in
  the DiT; then the fused decode.
- ``split_qkv``: ``bench.py --no-fused-qkv --int8-impl pallas`` (345
  patches): q, k, v and out_proj each int8_matmul behind its row-quant
  launch, flash_split, dense_gelu_quant for the patch embed and every
  mlp_in; then the fused decode.
- ``dynamic``: ``bench.py --precision int8 --int8-impl fused`` on
  ``DenseDiT`` with bench.py's bf16 parameters (the weights quantized at
  every call): matmul_fused for the patch embed's two products and the six
  of every block, flash_split; then the fused decode.
- ``bf16``: ``bench.py --bf16``, ``DenseDiT`` at precision bf16 with its
  bf16 parameters (q/k/v apart, 345 patches: align_n is the int8 DiT's):
  the products are ``torch.matmul``'s in bf16, flash_split a block; then
  the fused decode.
- ``fp32``: the main path's DiT at ``dtype="float32"`` (the fp32 compute
  dtype of the JAX package's import tool and of a run preset that sets
  it): the main path's kernels, each in its fp32 mode (norm_mod_dot,
  flash_qkv on ``csrc/attention_f32.cu``, matmul_fused and
  norm_mod_dense_gelu_quant a block, dense_gelu_quant for the patch
  embed), their launches counted apart as ``<kernel>_fp32`` (a wrapper's
  ``launches`` counts both modes, its ``f32_launches`` the fp32 one); then
  the fused decode.
- ``int8_qk``: the main path with ``--flash-int8-qk`` (flash_qkv with its
  s8 value product: a codes launch, then the attention, both counted apart
  from flash_qkv's bf16 launches, which are 0 here) and the decode under
  ``--snake-bf16`` (the DAC kernels' snake in bf16; their launches in that
  mode are counted apart too, and are 0 on every other path).
- ``v1legacy``: the ``v1legacy`` preset at full width (768 wide, 12
  layers, 12/12 heads, learned positions, attention biases; 345
  patches: no RoPE, so neither the fused prologue nor the flash-QKV
  kernel): flash_split at one q-head a kv-head and dense_gelu_quant; then
  the fused decode.
- ``fp32_third`` and ``fp32_split``: the third path and ``--no-flash-qkv``
  at ``dtype="float32"``, on the main path's workload: a block runs
  int8_matmul writing fp32 (behind w8a8_dot's torch row quant of the fp32
  qkv input), flash_out and int8_mlp in their fp32 modes
  (``csrc/attention_f32.cu``, ``csrc/mlp_full.cu``'s fp32 row quant), or
  flash_split in its fp32 mode and dense_gelu_quant's; dense_gelu_quant's
  fp32 mode for the patch embed; then the fused decode.  Each fp32 mode's
  launches are counted apart as ``<kernel>_fp32``.
- ``fp32_pallas``, ``fp32_pallas2`` and ``fp32_int8_qk``: ``--attention
  pallas``, ``--attention pallas2`` and ``--flash-int8-qk`` at fp32, on
  one 16 s chunk (1378 frames) at two Euler steps with CFG and no decode:
  gqa_attention, gqa_attention_grouped or flash_qkv's s8 value product in
  fp32 mode a block (``flash_qkv_int8_qk_fp32``, behind the codes launch
  on the fp32 v); counted, not timed, no CPU reference.

The attention kernels are also held against their plain versions at head
dim 32 (tiny's heads), at N = 1000, at head dims 128, 48 and 256 (v3's
heads, N = 345; 48 zero-padded to the 64 instance, 256 on the wide kernels
of ``csrc/attention_wide.cu``) and, B15 and B16, at N = 1378 (the
streaming mode), timed where they are past the paths' shapes, with the
bit-equalities at head dim 32, N = 864; B10 at head dims 32 and 256 (timed
at 256).  flash_qkv's int8 value product (``int8_qk``) at the main path's
shape with one of the padded rows past 345 holding every v column's max,
at 345 patches, at those head dims and N = 1000, and at D 128, N 700
(the streaming mode), within one bf16 ulp of the largest output and its
codes bit-equal to the plain version's; the four DAC kernels again with
the bf16 snake, at the same shapes, beside the same torch bf16 snake and
cuDNN, each also run in fp32 mode on the same inputs to show the mode
changes the result.  The eleven fp32 modes at their fp32 paths' shapes,
each timed beside its bf16 mode (``bf16_ms``): flash_split's,
gqa_attention's and gqa_attention_grouped's (``csrc/attention_f32.cu``,
rtol = atol = 1e-5, the last two bit-equal: one launch on one grid),
flash_out's (within REL_FLASH_OUT of max |plain|; then, through an
identity out projection, its codes within the row quant's code bounds,
which a head output in less than fp32 exceeds), int8_mlp's (its bf16 mode's bounds) and
flash_qkv's s8 value product (atol = rtol = 1e-2, at most 1 % of the
outputs past 1e-4, its codes of the fp32 v bit-equal), flash_qkv's (fp32
FMAs on the CUDA cores, rtol = atol = 1e-5), norm_mod_dot's (the fp32 prologue, the
GEMM's fp32 instance; at most 0.5 % of the outputs past 2^-20 relative, a
code moved by the statistics' order), norm_mod_dense_gelu_quant's and
dense_gelu_quant's (the fp32 row loads; the bf16 modes' code bounds) and
matmul_fused's.  B1 and B3
(norm_mod_dense_gelu_quant, norm_mod_dot) run the s8
wgmma GEMM of ``csrc/s8_wgmma.cuh`` on the weight K-major; the script
prints the share of B3's outputs past one bf16 ulp and of B1's codes off by
one against their plain versions.  B4 (matmul_fused) runs a row-quant
launch and the same s8 wgmma GEMM (``csrc/w8a8_fused.cu``), bit-equal to
its plain version, and so is its fp32 mode (an fp32 a, fp32 out: the row
quant on fp32 rows, the GEMM's fp32 instance), timed beside it, which
``w8a8_dot(impl="fused")`` takes for an fp32 lhs; B14 (int8_matmul) is that
GEMM alone, in bf16 and fp32
output, bit-equal to its plain version, and w8a8_dot(impl="pallas") (a
row-quant launch writing the unfloored scale, then B14) bit-equal to
impl="xla"; B12 (flash_out) runs its attention launch, then the same row
quant and GEMM with a bias.  B5 (dense_gelu_quant) runs a row-quant
launch and B1's two passes of that GEMM (``csrc/s8_gelu.cuh``), held in
both epilogue modes at both path shapes; B13 (int8_mlp) a row-quant launch, a first
product whose CTAs each keep one (64-row block, slab) of bf16 g in shared
memory and write its codes, and the second product folded slab by slab
(``csrc/mlp_full.cu``), each on the weights K-major.  B8 is the wgmma GEMM
of ``csrc/snake_tr_stream.cu``, checked and timed beside cuDNN at stage 0;
B7 (``csrc/snake_tr.cu``) one
wgmma launch at stages 2 and 3 and a snake pass in front of B8's kernel at
stage 1, checked at each stage's shape and at batch 2 with an odd T, each
stage's launches timed apart; B6 and B9 are the wgmma kernel of
``csrc/dac_res.cu``.

It checks each path's launch counts, the waveform (a finite latent on the
short paths), each full-width DiT but the short paths' on the card against
the same DiT's plain path on the CPU at a small input,
the full-width fused decoder on the card against its plain path on the
CPU (200 latent frames), and the fused decode against the unfused one on
the card (one segment).

Then the training paths: the training attention kernel (B10, forward and
backward) against its plain versions at the v3 training shapes, and its
fp32 mode (``csrc/attention_f32.cu``'s train mode, the backward
``csrc/attention_f32_bwd.cu``) at the same shapes in fp32 (within
REL_F32_TRAIN of max |plain|, two runs of each bit-equal, timed beside
fp32 SDPA), at D 32, 128, 256 and at N 768; then the ``v3mod2`` train step
at full width (766 M, batch 28 of 1378 frames, remat "full", dropout 0.1,
drop-path 0.05; the serving phase's dense weights) as its preset trains it
(``train``: bf16 compute, fp32 parameters), at ``dtype="float32"``
(``train_fp32``: every B10 launch in its fp32 mode) and at
``param_dtype="bfloat16"`` (``train_bf16_params``: bf16 parameters,
gradients and second moment): ``create_train_state`` (the state's GiB),
one counted step (B10 forward 56, backward 28), timed steps (finite
losses, moved parameters, the peak memory), and one step of each (all 28
blocks, batch 4) on the card against the CPU (plain versions) on the same
weights, batch and draws (TRAIN_REF_BOUNDS); and one step of the tiny
preset (head dim 32) on the card against the CPU.

The training entry point at full width: ``python -m jatsr_torch.cli.train
--preset v3mod2 --epochs 1 --native-loader`` on seeded latents (ten
2000-frame songs of 1024 fp16 channels: two steps of 28 crops; five for
validation: one batch), each step synchronised and timed with the
loader's wait, B10's launches a step (56 forward, 28 backward), the
bytes and seconds of each checkpoint written (``last``, ``best``: fp32
parameters and two fp32 moments); a fresh ``Trainer`` resumed from the
run directory (parameters, moments, count and step bit-equal to the first
trainer's) takes one more step; a tiny run trained the same way is served
by ``python -m jatsr_torch.cli.infer --run-dir`` on a ``.npy`` latent,
bit-equal to sampling with its restored parameters.  The run lives in a
temporary directory, removed at the end.  Then two ``v3mod2`` steps at
batch 28 under each remat policy ("none", "full", "dots", "attn_out",
"mlp") from the same weights, batch and draws: the first's B10 launches
(forward 28 under "none", 56 under the others) and parameters (within the
card-step bounds of those under "none"), the second's time, the peak
memory.

Data parallelism (``jatsr_torch/parallel/``) on the one card: B10 at a
batch offset (rows 14-27 of the training batch with ``b0 = 14``, bf16 and
fp32, forward and backward: bit-equal to those rows of the whole batch's
launch, within the plain version's bounds, timed against ``b0 = 0``);
inside the training entry point's phase, ``[dp nccl]``: the same v3mod2
run under ``python -m torch.distributed.run --standalone --nproc_per_node
1`` with ``--distributed --mesh 1 1 --shard-opt-state`` (NCCL, a world of
one), its ``last`` and ``best`` bit-equal to the plain run's, resumed for
a third step bit-equal to the resumed trainer's, and ``cli.infer --mesh 1
1`` on the tiny run bit-equal to the plain call's wav; after the remat
policies, ``[dp shared card]``: two ranks spawned on card 0 over gloo (NCCL refuses
two ranks on one GPU), two v3mod2 steps at batch 28 (14 a rank) with and
without ZeRO-1 against the single-card steps, and the main path's sampler
on a (2, 1) mesh against the single-card pass (bounds at ``DP_RANKS``);
then ``[tp shared card]``: the int8 DiT over two ranks of a (1, 2) mesh
on card 0, the split entries' shares against the whole kernels and every
serving branch's forward against one card (bounds at ``TP_STEPS``), whose
launches give the ``*_split`` kernel lines; then ``[tp train shared card]``:
``DenseDiT`` over two ranks of a (1, 2) mesh, B10 at a rank's heads
(``h0``), two v3mod2 steps (their losses, grad norms, first moments and
parameters) with one-step witnesses at fp32 and under dynamic int8, the
bf16 forward with its fp32 witness and the dynamic-int8 forward, each
against one card (bounds at ``TP_TRAIN_B``), whose B10 launches give the
``attention_train_{fwd,bwd}_h0`` kernel lines.

Audio in, audio out: 44.0 s of mono 16 kHz audio (704,000 samples from
the seed) through ``super_resolve_audio`` on the main path's DiT and the
fused codec with its encoder and nine-codebook RVQ: resampled to 44.1 kHz
(1,940,400 samples), encoded to the main path's 3790 frames, sampled and
decoded interleaved, its launches counted against the main path's, the
waveform checked, and the interleaved path held bit-equal to the
two-phase one under ``chunk_noise="batch"``.  On the card against the
CPU: the production encoder and RVQ on 4096 samples, the 16 kHz -> 44.1
kHz resample of 1 s, and one Heun call of the main path's sampler (its
forwards counted).

``python -m jatsr_torch.cli.evaluate`` grades the audio path's output
against its input (the report's LSD and mel numbers must be finite).

Data in, last: ``python -m jatsr_torch.cli.prepare_dataset`` on a corpus
of five synthetic songs at 48 and 44.1 kHz (60, 20, 12, 5 s, and 0.5 s,
under ``min_duration``) with the production codec at full width (random
weights from seed 0, as the CLI takes without ``--dac-weights``): the log
(four done, one skipped, no error), fp16 ``[frames, 1024]`` latents, the
stats files, ``LatentDataset`` and ``load_stats`` on them, audio-sec/s
and the peak memory; a second run encodes nothing; the pipeline in turns
without and with its prefetch thread (bit-equal to the CLI's latents);
the 60 s song alone; and one 1.5 s song on the card against the CPU
plain path.  The corpus lives in a temporary directory, removed at the
end.

The timed passes of the fifteen timed serving paths and the audio path run in
turns.  With
``--profile`` it then traces one more sampler call of each path, one more
decode of each (fused and unfused), one more train step and one more
step under each remat policy with ``torch.profiler`` and prints, for each, the card's busy share and device
time and launches by kernel name.

Every phase raises on failure.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit; before that, one JSON line of per-kernel measurements.
Without CUDA, or without the port beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
STEPS, CFG_SCALE = 8, 3.0
LATENT_FRAMES = 3790          # ~44 s: three 16 s chunks with 2 s crossfades
SEGMENT_FRAMES, CTX_FRAMES = 2756, 64
DECODE_L = SEGMENT_FRAMES + 2 * CTX_FRAMES  # frames of one decode call
TIMED_RUNS = 4                # timed serving passes of each path
SLEEP_CYCLES = 200_000_000    # the card's spin before a timed run of calls
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16 = 989e12            # dense tensor-core FLOP/s
PEAK_INT8 = 1979e12           # dense tensor-core OP/s
PEAK_FP32 = 67e12             # fp32 FLOP/s outside the tensor cores
B, NP, N_VALID, H = 6, 352, 345, 1280   # the main path's DiT batch and rows
# The training path: v3mod2 at its batch of 16 s crops; a short warmup so
# that the timed steps move the parameters (step 0 has lr 0, step 1 half).
TRAIN_B, TRAIN_FRAMES, TRAIN_N = 28, 1378, 345
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_TIMED_DTYPES = 3        # timed steps at fp32 and with bf16 parameters
REF_B = 4                     # the card-vs-CPU train step's batch

# bench.py's DiT at full width: its default (the fused prologue, which
# implies align_n), --no-fused-prologue, --flash-out --fused-mlp-impl full
# --int8-impl pallas (which keeps align_n), --no-flash-qkv, --attention
# pallas and --attention pallas2 (the last three on the split q/k/v).
SERVING = dict(param_dtype="bfloat16", dropout=0.0, drop_path_rate=0.0,
               matmul_precision="int8_static", fused_qkv=True, fused_mlp=True,
               fused_mlp_impl="half", attention_impl="flash", flash_qkv=True,
               gelu_impl="tanh", fast_epilogue=True, int8_impl="xla")
# Then the serving branches of the int8 DiT that the JAX CLI and bench.py
# reach besides: the CLI's --int8 --quantize-head (the unfused QuantDense
# MLP, the int8 head, the einsum attention, fp32 scores, no prologue),
# bench.py --no-fused-qkv --int8-impl pallas (q/k/v apart through B14),
# --flash-int8-qk --snake-bf16 (the main path with B2's s8 value product,
# the decode's snake in bf16), the v1legacy preset (learned positions,
# attention biases, 12/12 heads) and --precision int8 --int8-impl fused
# (the dynamic W8A8 model, DenseDiT, on bench.py's bf16 parameters).  Then
# bench.py --bf16 (DenseDiT at precision bf16 with its bf16 parameters: q/k/v
# apart, the split flash kernel) and the main path's DiT at the fp32 compute
# dtype (the model the JAX package's import tool and a run preset with
# "dtype": "float32" build: B3, B2, B4, B1 and B5 in their fp32 modes).
PATHS = {"prologue": dict(fused_prologue=True, align_n=True),
         "no_prologue": dict(fused_prologue=False, align_n=False),
         "opt_in": dict(fused_prologue=True, align_n=True,
                        flash_fused_out=True, fused_mlp_impl="full",
                        int8_impl="pallas"),
         "split_flash": dict(fused_prologue=True, align_n=True,
                             flash_qkv=False),
         "pallas": dict(fused_prologue=True, align_n=True,
                        attention_impl="pallas"),
         "pallas2": dict(fused_prologue=True, align_n=True,
                         attention_impl="pallas2"),
         "int8_cli": dict(fused_prologue=False, align_n=False,
                          fused_mlp=False, quantize_head=True,
                          attention_impl="xla", scores_dtype="float32"),
         "split_qkv": dict(fused_prologue=True, align_n=True,
                           fused_qkv=False, int8_impl="pallas"),
         "int8_qk": dict(fused_prologue=True, align_n=True,
                         flash_int8_qk=True),
         "v1legacy": dict(fused_prologue=True, align_n=True),
         "dynamic": dict(fused_prologue=True, align_n=True,
                         matmul_precision="int8", fused_qkv=False,
                         int8_impl="fused"),
         "bf16": dict(fused_prologue=True, align_n=True,
                      matmul_precision="bf16", fused_qkv=False),
         "fp32": dict(fused_prologue=True, align_n=True, dtype="float32")}
# Then every other serving branch at the fp32 compute dtype: the third path
# (B14 writing fp32, B12, B13 and B5 in fp32 mode) and --no-flash-qkv (B11)
# on the main path's workload, and --attention pallas, pallas2 and
# --flash-int8-qk (B15, B16, B2's s8 value product) on one 16 s chunk at
# SHORT_STEPS (SHORT), without the decode.
PATHS.update({f"fp32_{k}": dict(PATHS[p], dtype="float32") for k, p in (
    ("third", "opt_in"), ("split", "split_flash"), ("pallas", "pallas"),
    ("pallas2", "pallas2"), ("int8_qk", "int8_qk"))})
SHORT = ("fp32_pallas", "fp32_pallas2", "fp32_int8_qk")
SHORT_STEPS, SHORT_FRAMES = 2, 1378       # one 16 s chunk
PRESETS = {"v1legacy": "v1legacy"}        # the others: v3
SNAKE = {"int8_qk": "bfloat16"}           # the decode's snake; else fp32
FUSED_DECODE = {"prologue": True, "no_prologue": False,  # --fused-decode
                "opt_in": True, "split_flash": True, "pallas": True,
                "pallas2": True, "int8_cli": True, "split_qkv": True,
                "int8_qk": True, "v1legacy": True, "dynamic": True,
                "bf16": True, "fp32": True, "fp32_third": True,
                "fp32_split": True}
# The kernels the main path does not run, by the path the kernel line takes
# their launches from; the others' come from the main path.
KERNEL_PATH = {"flash_out": "opt_in", "int8_mlp": "opt_in",
               "int8_matmul": "opt_in", "flash_split": "split_flash",
               "gqa_attention": "pallas", "gqa_attention_grouped": "pallas2",
               "flash_qkv_int8_qk": "int8_qk",
               **{f"{k}_fp32": "fp32" for k in (
                   "flash_qkv", "norm_mod_dot", "matmul_fused",
                   "norm_mod_dense_gelu_quant", "dense_gelu_quant")},
               "flash_out_fp32": "fp32_third", "int8_mlp_fp32": "fp32_third",
               "flash_split_fp32": "fp32_split",
               "gqa_attention_fp32": "fp32_pallas",
               "gqa_attention_grouped_fp32": "fp32_pallas2",
               "flash_qkv_int8_qk_fp32": "fp32_int8_qk",
               **{f"{k}_snake_bf16": "int8_qk" for k in (
                   "snake_conv_transpose_streamed",
                   "snake_conv_transpose_fused", "res_stage_fused",
                   "res_unit_fused")},
               **{f"{k}_split": "tp" for k in (
                   "matmul_fused", "norm_mod_dense_gelu_quant",
                   "dense_gelu_quant", "int8_matmul", "flash_out",
                   "int8_mlp")}}
# Counted launches that are no kernel line of their own: w8a8_dot's row
# quant (XLA's in the JAX package) and B2's int8_qk codes launch (part of
# B2's option, timed on its line as codes_ms): checked on each path.
HELPERS = ("prequant_quant", "v_codes")


class Count:
    """The launch count a wrapper keeps under another name than
    ``launches`` (``gqa_attention_flash_qkv.int8_qk_launches``, the DAC
    wrappers' ``b16_launches``), read and set as ``launches``."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.fn, self.attr, n)


def log(*a):
    print(*a, flush=True)


class Phases:
    """Wall seconds of each phase, logged as it ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def done(self, name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - self.t:.1f} s (total "
            f"{now - self.t0:.1f} s)")
        self.t = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_report(log_text: str):
    """``(kernel, registers, spills)`` of each entry function in an
    ``nvcc -Xptxas -v`` log, the name demangled where ``c++filt`` is on the
    machine (a template's arguments show each head-dim instance)."""
    import re

    rows, name, spills = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif "spill stores" in line and name:
            if " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spills = line.strip()
        elif "Used " in line and " registers" in line and name:
            rows.append([name, int(line.split("Used ")[1].split()[0]),
                         spills])
            name = None
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        for r, p in zip(rows, plain):
            r[0] = p.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def time_ms(fn, arg_sets, reps):
    """Mean ms per call on the card (CUDA events), after a warm-up; calls
    rotate over ``arg_sets`` so that inputs do not stay in L2.  The card
    first spins (~0.1 s) while the host queues the calls, so that the
    events time the card's work and not the wrappers' Python, where that
    is the slower of the two."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotations(nbytes: int) -> int:
    """Copies of one input set that together exceed the 50 MB L2."""
    return max(2, min(32, math.ceil(96e6 / nbytes)))


def bound(nbytes: float, ops: float, peak: float, int8_ops: float = 0.0):
    """Least ms for the work: compulsory bytes at the HBM rate, or the
    operations at their type's peak (``int8_ops`` beside ``ops``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak + int8_ops / PEAK_INT8
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.nbytes for t in tensors)


def timings(kernel, plain, library, args, big, reps=100, plain_reps=20):
    """Kernel, plain and library ms at ``args``; the inputs at positions
    ``big`` are copied so that the kernel's and the library's calls rotate
    past L2.  ``library`` None: no one PyTorch call computes the function
    (``library_ms`` None)."""
    n = rotations(sum(args[i].nbytes for i in big))
    sets = [tuple(a.clone() if i in big else a for i, a in enumerate(args))
            for _ in range(n)]
    return {"ms": time_ms(kernel, sets, reps),
            "plain_ms": time_ms(plain, sets[:4], plain_reps),
            "library_ms": None if library is None else
            time_ms(library, sets, max(2, reps // 2))}


def sdpa_inputs(torch, qkv, cos, sin, hq, hkv):
    """The SDPA yardstick's inputs: the RoPE'd, head-split q/k/v (kv heads
    repeated; the tables in qkv's dtype, bf16 or fp32) and the main path's
    key mask."""
    from jatsr_torch.ops.attention import _rope

    D = qkv.shape[-1] // (hq + 2 * hkv)
    heads = qkv.reshape(B, NP, hq + 2 * hkv, D).permute(0, 2, 1, 3)
    cb, sb = cos.to(qkv.dtype), sin.to(qkv.dtype)
    q = _rope(heads[:, :hq], cb, sb).contiguous()
    k = _rope(heads[:, hq:hq + hkv], cb, sb).repeat_interleave(hq // hkv, 1)
    v = heads[:, hq + hkv:].repeat_interleave(hq // hkv, 1).contiguous()
    mask = (torch.arange(NP, device="cuda") < N_VALID)[None, None, None]
    return q, k, v, mask


def check_attention(torch):
    """flash_qkv against its plain version at the main path's qkv
    [6, 352, 1792] bf16 with keys masked past 345, and at the no-prologue
    path's [6, 345, 1792]; bit-equal at [6, 352] (no key masked) to
    flash_split on PyTorch's bf16 RoPE of q and k; timed at the main path's
    shape."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_rope, flash_qkv_plain,
                                           gqa_attention_flash,
                                           gqa_attention_flash_qkv)

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    err = 0.0
    for n, n_valid in ((NP, N_VALID), (N_VALID, 0)):
        x = qkv[:, :n].contiguous()
        c, s = cos[:n].contiguous(), sin[:n].contiguous()
        got = gqa_attention_flash_qkv(x, c, s, hq, hkv, n_valid=n_valid)
        want = flash_qkv_plain(x, c, s, hq, hkv, n_valid=n_valid)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        err = max(err, (got.float() - want.float()).abs().max().item())
    # B2's in-kernel RoPE against PyTorch's, through B11 (one body).
    heads = qkv.reshape(B, NP, hq + 2 * hkv, D)
    cb, sb = cos.bfloat16()[:, None], sin.bfloat16()[:, None]
    roped = (_rope(heads[:, :, :hq], cb, sb).reshape(B, NP, hq * D),
             _rope(heads[:, :, hq:hq + hkv], cb, sb).reshape(B, NP, hkv * D),
             qkv[..., (hq + hkv) * D:])
    a = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv)
    b = gqa_attention_flash(*roped, hq, hkv)
    torch.cuda.synchronize()
    d = (a.float() - b.float()).abs().max().item()
    log(f"[kernel] flash_qkv vs flash_split on PyTorch-roped q, k: max abs "
        f"{d:.3e}")
    if not torch.equal(a, b):
        raise AssertionError(f"flash_qkv and flash_split on roped inputs "
                             f"differ by up to {d}: they must be bit-equal")
    del heads, roped, a, b

    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)
    t = timings(lambda x, c, s, q, k, v: gqa_attention_flash_qkv(
                    x, c, s, hq, hkv, n_valid=N_VALID),
                lambda x, c, s, q, k, v: flash_qkv_plain(
                    x, c, s, hq, hkv, n_valid=N_VALID),
                lambda x, c, s, q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask),
                (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=200)
    nbytes = nbytes_of(qkv, cos, sin) + B * NP * hq * D * 2
    # Two products over the valid keys: what this run's mask needs.
    b_ms, b_by = bound(nbytes, 4 * B * hq * NP * N_VALID * D, PEAK_BF16)
    return {"name": "flash_qkv", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/attention_deferred.cu",
            "replaces": "ops/attention.py:415 (JAX package, "
                        "gqa_attention_flash_qkv; pallas_call :449)",
            "max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, NP, (hq + 2 * hkv) * D], "n_valid": N_VALID}


# B2 with int8_qk against its plain version.  Both take the same codes
# (v_codes_kernel bit-equal to v_codes_plain) and exact integer sums, so
# they part only where the score product's order moves an e across a code
# boundary or the fp32 scale product across a bf16 rounding boundary: at
# most one bf16 ulp of the largest output, at under INT8_QK_SHARE of the
# outputs.  This script's run on an H100 (700 W): at most 1.953e-3, half
# the bound, at 0.020-0.104 % of the outputs; the bf16 value product
# 3.503e-2 off at 91.7 % of them at the main shape.
INT8_QK_SHARE = 1e-2


def assert_int8_qk(torch, got, want, what):
    """``got`` (the kernel) against ``want`` (the plain version), both
    bf16: the bound above; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    share = (got != want).float().mean().item()
    log(f"[kernel] flash_qkv int8_qk {what}: max abs {err:.3e} (bound one "
        f"bf16 ulp of max |plain|, {ulp:.3e}), {share:.3e} of the outputs "
        f"differ")
    if not bool(torch.isfinite(got).all()) or err > ulp or \
            share > INT8_QK_SHARE:
        raise AssertionError(f"flash_qkv int8_qk {what}: max abs {err} > "
                             f"{ulp} or {share} of the outputs differ")
    return err


def check_v_codes(torch, qkv, hq, hkv, n_valid, what):
    """v_codes_kernel on ``qkv``'s v heads as flash_qkv's int8_qk launch
    makes them (heads zero-padded to the kernel's head dim, keys to the
    plan's count) against v_codes_plain: codes and scales bit for bit."""
    from jatsr_torch.ops.attention import (_deferred_plan, _row_view,
                                           _sm_count, _v_codes, pad_heads,
                                           padded_head_dim, v_codes_plain)

    Bn, N, TD = qkv.shape
    D = TD // (hq + 2 * hkv)
    Dp = padded_head_dim(D)
    v, v_row = _row_view(pad_heads(qkv[..., (hq + hkv) * D:], D, Dp))
    nk = _deferred_plan(N, hq, hkv, Dp, Bn, _sm_count(qkv.device.index),
                        n_valid or N, False).nk
    codes, sv = _v_codes(v, v_row, hkv, Dp, nk)
    want_codes, want_sv = v_codes_plain(v, hkv, nk)
    if not (torch.equal(codes, want_codes) and torch.equal(sv, want_sv)):
        raise AssertionError(f"v_codes {what}: codes or scales differ from "
                             f"the plain version's")
    log(f"[kernel] v_codes {what}: codes and scales bit-equal")


def check_attention_int8_qk(torch):
    """flash_qkv with int8_qk (B2's s8 value product: a v_codes launch, then
    the attention launch) against its plain version at the main path's qkv
    [6, 352, 1792] (keys masked past 345) with one of the padded rows
    between 345 and 352 holding every v column's absmax (the codes' scale
    is taken over all 352 rows, as in the JAX kernel), and at [6, 345,
    1792]; at D 128 and N 700 (past 640 keys: the streaming mode); each
    within ``assert_int8_qk``'s bound, its codes bit-equal to the plain
    version's, and at the main shape the bf16 value product (flash_qkv
    without int8_qk) outside that bound.  Timed at the main path's shape
    beside SDPA, and its codes launch alone; the bound counts the score
    product at the bf16 peak and the value product at the int8 peak."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_row_view, _v_codes,
                                           flash_qkv_plain,
                                           gqa_attention_flash_qkv)

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    qkv[:, N_VALID + 3, (hq + hkv) * D:] = 6.0  # a padded row: every max
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    err = 0.0
    cases = [(qkv, cos, sin, hq, hkv, N_VALID),
             (qkv[:, :N_VALID].contiguous(), cos[:N_VALID].contiguous(),
              sin[:N_VALID].contiguous(), hq, hkv, 0)]
    g2 = torch.Generator(device="cuda").manual_seed(SEED + 41)
    c7, s7 = rope_cos_sin(700, 128, device="cuda")
    cases.append((torch.randn((2, 700, 8 * 128), generator=g2,
                              device="cuda").bfloat16(), c7, s7, 4, 2, 690))
    for x, c, s, h1, h2, n_valid in cases:
        got = gqa_attention_flash_qkv(x, c, s, h1, h2, n_valid=n_valid,
                                      int8_qk=True)
        want = flash_qkv_plain(x, c, s, h1, h2, n_valid=n_valid,
                               int8_qk=True)
        torch.cuda.synchronize()
        what = f"{tuple(x.shape)} n_valid {n_valid}"
        err = max(err, assert_int8_qk(torch, got, want, what))
        check_v_codes(torch, x, h1, h2, n_valid, what)
    # The bound tells the two value products apart.
    want = flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=N_VALID,
                           int8_qk=True)
    try:
        assert_int8_qk(torch, gqa_attention_flash_qkv(
            qkv, cos, sin, hq, hkv, n_valid=N_VALID), want, "(bf16 value "
            "product against the int8 plain version)")
    except AssertionError:
        pass
    else:
        raise AssertionError("the bf16 value product passes int8_qk's bound")
    del want
    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)
    t = timings(lambda x, c, s, q, k, v: gqa_attention_flash_qkv(
                    x, c, s, hq, hkv, n_valid=N_VALID, int8_qk=True),
                lambda x, c, s, q, k, v: flash_qkv_plain(
                    x, c, s, hq, hkv, n_valid=N_VALID, int8_qk=True),
                lambda x, c, s, q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask),
                (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=200)
    views = [_row_view(x[..., (hq + hkv) * D:]) for x in
             [qkv.clone() for _ in range(rotations(qkv.nbytes))]]
    t["codes_ms"] = time_ms(lambda v, row: _v_codes(v, row, hkv, D, 384),
                            views, 200)
    nbytes = nbytes_of(qkv, cos, sin) + B * NP * hq * D * 2
    prod = 2 * B * hq * NP * N_VALID * D  # each product, the valid keys
    b_ms, b_by = bound(nbytes, prod, PEAK_BF16, int8_ops=prod)
    return {"name": "flash_qkv_int8_qk", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/attention_deferred.cu",
            "replaces": "ops/attention.py:415 (JAX package, "
                        "gqa_attention_flash_qkv with int8_qk, :276-290 and "
                        ":387-395; pallas_call :449)",
            "max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, NP, (hq + 2 * hkv) * D], "n_valid": N_VALID}


def check_dac_kernels_snake_bf16(torch):
    """The four DAC kernels at the fused decode's shapes with the snake in
    bf16 (``set_snake_compute_dtype("bfloat16")``; ``bench.py
    --snake-bf16``), against their plain versions in the same mode, and
    timed beside the same torch bf16 snake and cuDNN.  Entries named
    ``<kernel>_snake_bf16``."""
    from jatsr_torch.ops import dac_kernels as dk

    dk.set_snake_compute_dtype("bfloat16")
    try:
        out = check_dac_kernels(torch)
    finally:
        dk.set_snake_compute_dtype("float32")
    renamed = {}
    for name, c in out.items():
        c = dict(c, name=f"{name}_snake_bf16",
                 replaces=c["replaces"] + " with SNAKE_COMPUTE_DTYPE "
                          "bfloat16, ops/dac_kernels.py:83-106")
        renamed[f"{name}_snake_bf16"] = c
    return renamed


def check_split_attention(torch):
    """flash_split (B11), gqa_attention (B15) and gqa_attention_grouped
    (B16) against their plain versions at the split paths' q [6, 345, 20,
    64] and k/v [6, 345, 4, 64] bf16 (k and v column slices of one fused
    projection, as the model hands v over), B15 bit-equal to B16; B11 also
    where every real score is negative, so that its zero keys set the row
    max; each timed on contiguous copies beside SDPA at N = 345 with the kv
    heads repeated (no mask needed there)."""
    import torch.nn.functional as F

    from jatsr_torch.ops.attention import (flash_split_plain, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_grouped,
                                           gqa_attention_plain)

    hq, hkv, D, N = 20, 4, 64, N_VALID
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    views = (qkv[..., :hq * D].reshape(B, N, hq, D),
             qkv[..., hq * D:(hq + hkv) * D].reshape(B, N, hkv, D),
             qkv[..., (hq + hkv) * D:].reshape(B, N, hkv, D))

    def flat(x):
        return x.reshape(B, N, -1)

    def heads(x):  # [B, N, h, D] -> [B, hq, N, D], kv heads repeated
        return x.transpose(1, 2).repeat_interleave(
            hq // x.shape[2], 1).contiguous()

    kernels = {
        "flash_split": (
            lambda q, k, v, *_: gqa_attention_flash(flat(q), flat(k),
                                                    flat(v), hq, hkv),
            lambda q, k, v, *_: flash_split_plain(flat(q), flat(k), flat(v),
                                                  hq, hkv),
            "ops/attention.py:186 (JAX package, gqa_attention_flash; "
            "pallas_call :213)"),
        "gqa_attention": (
            lambda q, k, v, *_: gqa_attention(q, k, v),
            lambda q, k, v, *_: gqa_attention_plain(q, k, v),
            "ops/attention.py:78 (JAX package, gqa_attention; "
            "pallas_call :109)"),
        "gqa_attention_grouped": (
            lambda q, k, v, *_: gqa_attention_grouped(q, k, v),
            lambda q, k, v, *_: gqa_attention_plain(q, k, v),
            "ops/attention.py:619 (JAX package, gqa_attention_grouped; "
            "pallas_call :651)"),
    }
    q, k, v = (x.contiguous() for x in views)
    args = (q, k, v, heads(q), heads(k), heads(v))
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    b_ms, b_by = bound(nbytes, 4 * B * hq * N * N * D, PEAK_BF16)
    out, got = {}, {}
    for name, (kernel, plain, replaces) in kernels.items():
        got[name] = kernel(*views).float()
        want = plain(*views).float()
        torch.cuda.synchronize()
        torch.testing.assert_close(got[name], want, atol=2e-2, rtol=2e-2)
        t = timings(kernel, plain,
                    lambda *a: F.scaled_dot_product_attention(*a[3:]), args,
                    big=(0, 1, 2, 3, 4, 5), reps=200)
        out[name] = {"name": name, "route": "cuda",
                     "source": ("jatsr_torch/ops/csrc/attention_deferred.cu"
                                if name == "flash_split" else
                                "jatsr_torch/ops/csrc/attention_natural.cu"),
                     "replaces": replaces,
                     "max_abs_err": (got[name] - want).abs().max().item(),
                     **t, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": [B, N, hq, hkv, D]}
    d = (got["gqa_attention"] - got["gqa_attention_grouped"]).abs().max()
    log(f"[kernel] gqa_attention vs gqa_attention_grouped: max abs "
        f"{d.item():.3e}")
    if d.item() != 0.0:  # one body, and no row's arithmetic depends on the grid
        raise AssertionError(f"gqa_attention and gqa_attention_grouped differ "
                             f"by up to {d.item()}: they must be bit-equal")
    out["gqa_attention"]["vs_grouped_max_abs"] = d.item()
    # B11's zero keys (345 padded to 352) set the max of every row.  v is
    # about 1, so every output is about 1: a kernel that left the zero
    # keys' share in l (7 % of it) would miss every output by about 2.8
    # times the tolerance.
    qp = (views[0].float().abs() * 0.5).bfloat16()
    kp = (views[1].float().abs() * -0.5).bfloat16()
    vp = (views[2].float() * 0.5 + 1).bfloat16()
    got = gqa_attention_flash(flat(qp), flat(kp), flat(vp), hq, hkv).float()
    want = flash_split_plain(flat(qp), flat(kp), flat(vp), hq, hkv).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    out["flash_split"]["pad_keys_max_abs_err"] = (got - want).abs().max(
        ).item()
    return out


# ---- the attention kernels at other head dims and past 768 keys ------------
# Each against its plain version under the path shapes' tolerances
# (attention atol = rtol = 2e-2; B12 1e-2 x max |plain|): at tiny's heads
# (4/2, head dim 32, N 345, keys masked past 340 for B2 and B12), and at
# N = 1000, the largest patch count JAX's flash_supported admits at head dim
# 16 (B2, B11, B12 at v1's 8/4 heads, out projection 512 wide; B15, B16 at
# v3's 20/4; head dim 64), where each is also timed; and the bit-equalities
# at head dim 32, N = 864.  Then at v3's 20/4 heads and N = 345 (keys masked
# past 340), out projection 1280 wide, with head dim 128 (its own instance,
# 8-warp CTAs) and 48 (zero-padded to the 64 instance), and B15 and B16 at
# N = 1378 (a 16 s chunk unpatchified: the streaming mode), each timed.
EXTRA_B = 6
EXTRA_N = 1000
LONG_N = 1378
SPLIT_KERNELS = ("gqa_attention", "gqa_attention_grouped")


def attention_extra(torch, hq, hkv, D, N, n_valid, H, seed, split_heads,
                    timed, only=None):
    """B2, B11, B12 on one fused projection, B15 and B16 on split views of
    ``split_heads`` heads (``only``: these of them):
    {kernel: {"shape", "max_abs_err"[, "ms"]}}."""
    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (flash_out_plain, flash_qkv_plain,
                                           flash_out_weight_t,
                                           flash_split_plain, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_flash_out,
                                           gqa_attention_flash_qkv,
                                           gqa_attention_grouped,
                                           gqa_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((EXTRA_B, N, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(N, D, device="cuda")
    q, k, v = (qkv[..., :hq * D], qkv[..., hq * D:(hq + hkv) * D],
               qkv[..., (hq + hkv) * D:])
    _, wo_q, wo_s, bo = dense_inputs(torch, 1, hq * D, H, seed + 1)
    wo_t = flash_out_weight_t(wo_q, hq, D)  # made once, as the DiT makes it
    shq, shkv = split_heads
    split = torch.randn((EXTRA_B, N, (shq + 2 * shkv) * D), generator=gen,
                        device="cuda").bfloat16()
    q4, k4, v4 = (split[..., a * D:b * D].reshape(EXTRA_B, N, -1, D)
                  for a, b in ((0, shq), (shq, shq + shkv),
                               (shq + shkv, shq + 2 * shkv)))
    cases = {
        "flash_qkv": (lambda: gqa_attention_flash_qkv(
            qkv, cos, sin, hq, hkv, n_valid=n_valid), lambda: flash_qkv_plain(
            qkv, cos, sin, hq, hkv, n_valid=n_valid), None),
        "flash_qkv_int8_qk": (lambda: gqa_attention_flash_qkv(
            qkv, cos, sin, hq, hkv, n_valid=n_valid, int8_qk=True),
            lambda: flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=n_valid,
                                    int8_qk=True), None),
        "flash_split": (lambda: gqa_attention_flash(q, k, v, hq, hkv),
                        lambda: flash_split_plain(q, k, v, hq, hkv), None),
        "flash_out": (lambda: gqa_attention_flash_out(
            qkv, cos, sin, wo_q, wo_s, bo, hq, hkv, n_valid=n_valid,
            wo_t=wo_t),
            lambda: flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                    n_valid=n_valid), REL_FLASH_OUT),
        "gqa_attention": (lambda: gqa_attention(q4, k4, v4),
                          lambda: gqa_attention_plain(q4, k4, v4), None),
        "gqa_attention_grouped": (lambda: gqa_attention_grouped(q4, k4, v4),
                                  lambda: gqa_attention_plain(q4, k4, v4),
                                  None),
    }
    out, got = {}, {}
    for name, (kernel, plain, rel) in cases.items():
        if only is not None and name not in only:
            continue
        got[name] = kernel().float()
        want = plain().float()
        torch.cuda.synchronize()
        err = (got[name] - want).abs().max().item()
        if name == "flash_qkv_int8_qk":
            what = f"N {N}, D {D}"
            assert_int8_qk(torch, got[name], want, what)
            check_v_codes(torch, qkv, hq, hkv, n_valid, what)
        elif rel is None:
            torch.testing.assert_close(got[name], want, atol=2e-2, rtol=2e-2)
        elif not bool(torch.isfinite(got[name]).all()) or \
                err > rel * want.abs().max().item():
            raise AssertionError(f"{name} at N {N}, D {D}: max abs {err}")
        heads = split_heads if name.startswith("gqa") else (hq, hkv)
        out[name] = {"shape": [EXTRA_B, N, *heads, D], "max_abs_err": err}
        if timed:
            out[name]["ms"] = time_ms(lambda *_: kernel(), [()], 50)
    if not torch.equal(got["gqa_attention"], got["gqa_attention_grouped"]):
        raise AssertionError(f"gqa_attention and gqa_attention_grouped differ "
                             f"at N {N}, D {D}")
    return out


def check_attention_extra(torch):
    """The five serving attention kernels at head dims 32, 128 and 48 and at
    N = 1000, B15 and B16 at N = 1378, and the bit-equalities at head dim
    32, N = 864 (see above)."""
    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_rope, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_flash_qkv,
                                           gqa_attention_grouped)

    d32 = attention_extra(torch, 4, 2, 32, N_VALID, N_VALID - 5, 128,
                          SEED + 30, (4, 2), timed=False)
    far = attention_extra(torch, 8, 4, 64, EXTRA_N, EXTRA_N - 3, 512,
                          SEED + 31, (20, 4), timed=True)
    wide = {D: attention_extra(torch, 20, 4, D, N_VALID, N_VALID - 5, H,
                               SEED + 33 + D, (20, 4), timed=True)
            for D in (128, 48, 256)}
    long = attention_extra(torch, 20, 4, 64, LONG_N, LONG_N, H, SEED + 35,
                           (20, 4), timed=True, only=SPLIT_KERNELS)
    log(f"[kernel] N {LONG_N}: gqa_attention == gqa_attention_grouped, bit "
        f"for bit (the streaming mode)")
    B_, N, hq, hkv, D = 2, 864, 4, 2, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    qkv = torch.randn((B_, N, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(N, D, device="cuda")
    heads = qkv.reshape(B_, N, hq + 2 * hkv, D)
    cb, sb = cos.bfloat16()[:, None], sin.bfloat16()[:, None]
    q = _rope(heads[:, :, :hq], cb, sb)
    k = _rope(heads[:, :, hq:hq + hkv], cb, sb)
    v = heads[:, :, hq + hkv:]
    a = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv)
    b = gqa_attention_flash(q.reshape(B_, N, -1), k.reshape(B_, N, -1),
                            v.reshape(B_, N, -1), hq, hkv)
    if not torch.equal(a, b):
        raise AssertionError("flash_qkv and flash_split on roped inputs "
                             "differ at D 32, N 864")
    if not torch.equal(gqa_attention(q, k, v), gqa_attention_grouped(q, k,
                                                                      v)):
        raise AssertionError("gqa_attention and gqa_attention_grouped "
                             "differ at D 32, N 864")
    log("[kernel] D 32, N 864: flash_qkv == flash_split on roped inputs, "
        "gqa_attention == gqa_attention_grouped, bit for bit")
    out = {name: {"head_dim_32": d32[name], f"n_{EXTRA_N}": far[name],
                  "head_dim_128": wide[128][name],
                  "head_dim_48": wide[48][name],
                  "head_dim_256": wide[256][name]} for name in d32}
    for name in SPLIT_KERNELS:
        out[name][f"n_{LONG_N}"] = long[name]
    return out


def dense_inputs(torch, M, K, N, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_s = torch.rand((1, N), generator=gen, device="cuda") \
        .add_(0.5).div_(127 * K ** 0.5)
    b = 0.1 * torch.randn((1, N), generator=gen, device="cuda")
    return a, w_q, w_s, b


def identity_codes(out):
    """The codes and row scales of an identity out projection's output
    ``o_q * so``, a row a token (each row's largest code is 127)."""
    import torch

    out = out.reshape(-1, out.shape[-1])
    so = out.abs().amax(dim=1, keepdim=True) / 127
    return torch.round(out / so).to(torch.int8), so


def assert_codes(what, got_q, got_s, want_q, want_s, scale_rtol=1e-5):
    """int8 codes equal but for <= 0.5% off by exactly one (tanhf/expf
    differ in the last bit); scales within ``scale_rtol``."""
    import torch

    diff = (got_q.int() - want_q.int()).abs()
    frac = (diff != 0).float().mean().item()
    if diff.max().item() > 1 or frac > 0.005:
        raise AssertionError(f"{what}: codes differ by up to "
                             f"{diff.max().item()} on {frac:.4%}")
    torch.testing.assert_close(got_s, want_s, rtol=scale_rtol, atol=0)
    return diff.max().item(), frac


def check_dense_gelu(torch, M, K, N):
    """dense_gelu_quant (B5) against its plain version at one path shape,
    in both epilogue modes (fp32, and y and g rounded to bf16); timed in
    the paths' mode (fp32).  The kernel reads the weight K-major (``w_t``),
    made once, as the DiT makes it."""
    import torch.nn.functional as F

    from jatsr_torch.ops.int8_matmul import (_INV127, dense_gelu_quant_plain,
                                             int8_dense_gelu_quant, int8_mm,
                                             quantize_rows)

    args = dense_inputs(torch, M, K, N, SEED + K)
    w_t = args[1].t().contiguous()
    err = frac = 0.0
    for fast in (False, True):
        got_q, got_s = int8_dense_gelu_quant(*args, fast_epilogue=fast,
                                             w_t=w_t)
        want_q, want_s = dense_gelu_quant_plain(*args, fast_epilogue=fast)
        torch.cuda.synchronize()
        e, f = assert_codes(f"dense_gelu_quant {M}x{K}x{N} fast={fast}",
                            got_q, got_s, want_q, want_s)
        err, frac = max(err, e), max(frac, f)

    def library(a, w_q, w_s, b, _):
        a_q, s = quantize_rows(a)
        y = int8_mm(a_q, w_q).float() * s.clamp_min(1e-12) * w_s + b
        g = F.gelu(y, approximate="tanh")
        gs = (g.abs().amax(1, keepdim=True) * _INV127).clamp_min(1e-12)
        return torch.round(g / gs).to(torch.int8), gs

    t = timings(lambda a, w_q, w_s, b, w_t: int8_dense_gelu_quant(
                    a, w_q, w_s, b, w_t=w_t),
                lambda *x: dense_gelu_quant_plain(*x[:4]), library,
                (*args, w_t), big=(0, 1, 4))
    b_ms, b_by = bound(nbytes_of(*args, got_q, got_s), 2 * M * K * N,
                       PEAK_INT8)
    return {"shape": [M, K, N], "max_abs_err": err, "code_mismatch_frac": frac,
            **t, "bound_ms": b_ms, "bound_by": b_by}


def prologue_inputs(torch, N, seed):
    """The raw residual stream [6, 352, 1280] bf16, the AdaLN rows
    (bf16-valued fp32) per sample [6, H] and shared [1, H], and an int8
    [H, N] projection."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn((B, NP, H), generator=gen, device="cuda")
         + 0.3).bfloat16()
    mod = (0.5 * torch.randn((2, B, H), generator=gen, device="cuda")
           ).bfloat16().float()
    _, w_q, w_s, b = dense_inputs(torch, 1, H, N, seed + 1)
    return x, (mod[0], mod[1]), (mod[0, :1], mod[1, :1]), w_q, w_s, b


def torch_prologue(torch, x, sc, sh, norm):
    """The yardstick's prologue: PyTorch's own norm, bf16 modulate, then
    the row quantisation."""
    import torch.nn.functional as F

    from jatsr_torch.ops.int8_matmul import quantize_rows

    xf = x.float()
    xn = (F.rms_norm(xf, (H,), eps=1e-6) if norm == "rms"
          else F.layer_norm(xf, (H,), eps=1e-6))
    y = xn.bfloat16() * (1 + sc[:, None]).bfloat16() + sh[:, None].bfloat16()
    a_q, s = quantize_rows(y.reshape(-1, H))
    return a_q, s.clamp_min(1e-12)


def check_norm_mod_dot(torch, norm):
    """norm_mod_dot (qkv) against its plain version at [6, 352, 1280] x
    [1280, 1792], both norms, per-sample and shared AdaLN rows."""
    from jatsr_torch.ops.int8_matmul import int8_mm
    from jatsr_torch.ops.prologue import int8_norm_mod_dot, norm_mod_dot_plain

    N = 1792
    x, per, shared, w_q, w_s, b = prologue_inputs(torch, N, SEED + 1)
    w_t = w_q.t().contiguous()  # the K-major copy the DiT makes once
    err = far = 0.0
    for kind in ("rms", "layer"):
        for sc, sh in (per, shared):
            got = int8_norm_mod_dot(x, sc, sh, w_q, w_s, b, norm=kind,
                                    w_t=w_t).float()
            want = norm_mod_dot_plain(x, sc, sh, w_q, w_s, b, kind).float()
            torch.cuda.synchronize()
            # One bf16 ulp, but for rows whose code moved by one where the
            # fp32 statistics differ in the last bit.
            f = ((got - want).abs() > want.abs() * 2.0 ** -7).float().mean()
            far = max(far, f.item())
            err = max(err, (got - want).abs().max().item())
            if far > 0.005:
                raise AssertionError(f"norm_mod_dot {kind}: {far:.4%} of the "
                                     f"outputs differ by more than 1 ulp")

    def library(x, sc, sh, w_q, w_s, b):
        a_q, s = torch_prologue(torch, x, sc, sh, norm)
        y = int8_mm(a_q, w_q).float() * s * w_s + b
        return y.bfloat16().reshape(B, NP, N)

    log(f"[kernel] norm_mod_dot: {far:.6%} of the outputs past one bf16 "
        f"ulp of the plain version's")
    sc, sh = shared  # the sampler's hoisted row, as on the main path
    t = timings(lambda *a: int8_norm_mod_dot(*a[:6], norm=norm, w_t=a[6]),
                lambda *a: norm_mod_dot_plain(*a[:6], norm=norm),
                lambda *a: library(*a[:6]), (x, sc, sh, w_q, w_s, b, w_t),
                big=(0, 3, 6))
    b_ms, b_by = bound(nbytes_of(x, sc, sh, w_q, w_s, b) + B * NP * N * 2,
                       2 * B * NP * H * N, PEAK_INT8)
    return {"name": "norm_mod_dot", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/norm_mod.cu",
            "replaces": "ops/int8_matmul.py:419 (JAX package, "
                        "int8_norm_mod_dot; pallas_call :452)",
            "max_abs_err": err, "beyond_1ulp_frac": far, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [B, NP, H, N]}


def check_norm_mod_gelu(torch, norm):
    """norm_mod_dense_gelu_quant (mlp_in) against its plain version at
    [6, 352, 1280] x [1280, 5120], both norms and both row shapes."""
    from jatsr_torch.ops.int8_matmul import _INV127, _gelu, int8_mm
    from jatsr_torch.ops.prologue import (int8_norm_mod_dense_gelu_quant,
                                          norm_mod_dense_gelu_quant_plain)

    N = 5120
    x, per, shared, w_q, w_s, b = prologue_inputs(torch, N, SEED + 2)
    w_t = w_q.t().contiguous()
    err = frac = 0.0
    for kind in ("rms", "layer"):
        for sc, sh in (per, shared):
            got = int8_norm_mod_dense_gelu_quant(x, sc, sh, w_q, w_s, b,
                                                 norm=kind, w_t=w_t)
            want = norm_mod_dense_gelu_quant_plain(x, sc, sh, w_q, w_s, b,
                                                   kind)
            torch.cuda.synchronize()
            # The prologue's fp32 sums run in another order than the plain
            # version's: a moved input code shifts its row's products by
            # w/127 of a column, and so the row's scale, by up to ~1e-3.
            e, f = assert_codes(f"norm_mod_dense_gelu_quant {kind}", *got,
                                *want, scale_rtol=2e-3)
            err, frac = max(err, e), max(frac, f)

    def library(x, sc, sh, w_q, w_s, b):
        a_q, s = torch_prologue(torch, x, sc, sh, norm)
        g = _gelu(int8_mm(a_q, w_q).float() * s * w_s + b)
        gs = (g.abs().amax(1, keepdim=True) * _INV127).clamp_min(1e-12)
        return torch.round(g / gs).to(torch.int8), gs

    log(f"[kernel] norm_mod_dense_gelu_quant: {frac:.6%} of the codes off "
        f"by one from the plain version's")
    sc, sh = shared
    t = timings(lambda *a: int8_norm_mod_dense_gelu_quant(*a[:6], norm=norm,
                                                          w_t=a[6]),
                lambda *a: norm_mod_dense_gelu_quant_plain(*a[:6], norm=norm),
                lambda *a: library(*a[:6]), (x, sc, sh, w_q, w_s, b, w_t),
                big=(0, 3, 6))
    b_ms, b_by = bound(nbytes_of(x, sc, sh, w_q, w_s, b) + B * NP * (N + 4),
                       2 * B * NP * H * N, PEAK_INT8)
    return {"name": "norm_mod_dense_gelu_quant", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/norm_mod.cu",
            "replaces": "ops/int8_matmul.py:555 (JAX package, "
                        "int8_norm_mod_dense_gelu_quant; pallas_call :592)",
            "max_abs_err": err, "code_mismatch_frac": frac, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [B, NP, H, N]}


def check_matmul_fused(torch):
    """matmul_fused (out_proj, B4) against its plain version at [2112, 1280]
    x [1280, 1280], with an all-zero row (the floored scale) and a row whose
    one large value sets its scale: bit-equal.  The kernel reads the weight
    K-major (``w_t``), made once, as the DiT makes it."""
    from jatsr_torch.ops.int8_matmul import (int8_matmul_fused,
                                             matmul_fused_plain)
    from jatsr_torch.ops.quant import w8a8_dot

    M = B * NP
    a, w_q, w_s, _ = dense_inputs(torch, M, H, H, SEED + 3)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    w_t = w_q.t().contiguous()
    got = int8_matmul_fused(a, w_q, w_s, w_t=w_t)
    want = matmul_fused_plain(a, w_q, w_s)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("matmul_fused: not bit-equal to its plain "
                             "version")
    t = timings(lambda a, w_q, w_s, w_t: int8_matmul_fused(a, w_q, w_s,
                                                           w_t=w_t),
                lambda a, w_q, w_s, w_t: matmul_fused_plain(a, w_q, w_s),
                lambda a, w_q, w_s, w_t: w8a8_dot(a, w_q, w_s),
                (a, w_q, w_s, w_t), big=(0, 1, 3))
    b_ms, b_by = bound(nbytes_of(a, w_q, w_s, got), 2 * M * H * H, PEAK_INT8)
    return {"name": "matmul_fused", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/w8a8_fused.cu",
            "replaces": "ops/int8_matmul.py:103 (JAX package, "
                        "int8_matmul_fused; pallas_call :151)",
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            **t, "bound_ms": b_ms, "bound_by": b_by, "shape": [M, H, H],
            "fp32": check_b4_fp32(torch, a, w_q, w_s, w_t)}


# ---- the split entries of tensor parallelism (ops/split.py) ---------------
# Each at a rank's shapes on a (1, 2) mesh of v3 (mlp_in's 2560 columns,
# out_proj's 640 input columns and kernel rows), in one process (no
# collective): bit-equal to the whole-width kernel on the same columns (the
# rank's own row maxima are then the whole row's) and to, or within the
# whole kernel's bound of, the plain version; timed beside the whole
# kernel on the same columns; no one PyTorch call computes a rank's share
# (library_ms None).  [tp shared card] joins two ranks' shares.
TP_M = 2


def check_split_kernels(torch, norm, checks):
    """The three split entries' kernel lines (see the comment above)."""
    from jatsr_torch.ops import split as sp
    from jatsr_torch.ops.int8_matmul import (dense_gelu_quant_plain,
                                             int8_dense_gelu_quant,
                                             int8_matmul_fused,
                                             matmul_fused_plain)
    from jatsr_torch.ops.prologue import (int8_norm_mod_dense_gelu_quant,
                                          norm_mod_dense_gelu_quant_plain)

    out = {}
    # B1: [6, 352, 1280] x [1280, 5120 / M], the shared AdaLN row.
    N = 5120 // TP_M
    x, _, (sc, sh), w_q, w_s, b = prologue_inputs(torch, N, SEED + 2)
    w_t = w_q.t().contiguous()
    got = sp.int8_norm_mod_dense_gelu_quant_split(x, sc, sh, w_q, w_s, b,
                                                  None, norm=norm, w_t=w_t)
    whole = int8_norm_mod_dense_gelu_quant(x, sc, sh, w_q, w_s, b, norm=norm,
                                           w_t=w_t)
    want = sp.int8_norm_mod_dense_gelu_quant_split(
        x.cpu(), sc.cpu(), sh.cpu(), w_q.cpu(), w_s.cpu(), b.cpu(), None,
        norm=norm)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])):
        raise AssertionError("norm_mod_dense_gelu_quant_split: not the whole "
                             "kernel's bits on its columns")
    err, frac = assert_codes("norm_mod_dense_gelu_quant_split",
                             got[0].cpu(), got[1].cpu(), *want,
                             scale_rtol=2e-3)
    args = (x, sc, sh, w_q, w_s, b, w_t)
    t = timings(
        lambda *a: sp.int8_norm_mod_dense_gelu_quant_split(
            *a[:6], None, norm=norm, w_t=a[6]),
        lambda *a: norm_mod_dense_gelu_quant_plain(*a[:6], norm=norm), None,
        args, big=(0, 3, 6))
    whole_ms = time_ms(lambda *a: int8_norm_mod_dense_gelu_quant(
        *a[:6], norm=norm, w_t=a[6]), [args], 100)
    b_ms, b_by = bound(nbytes_of(x, sc, sh, w_q, w_s, b) + B * NP * (N + 4),
                       2 * B * NP * H * N, PEAK_INT8)
    line = checks["norm_mod_dense_gelu_quant"]
    out["norm_mod_dense_gelu_quant_split"] = {
        "name": "norm_mod_dense_gelu_quant_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/norm_mod.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's columns",
        "max_abs_err": err, "code_mismatch_frac": frac, **t,
        "bound_ms": b_ms, "bound_by": b_by, "shape": [B, NP, H, N],
        "whole_same_columns_ms": whole_ms, "whole_full_width_ms": line["ms"]}

    # B5: mlp_in without the prologue, [2070, 1280] x [1280, 5120 / M].
    M = B * N_VALID
    a, w_q, w_s, b = dense_inputs(torch, M, H, N, SEED + 21)
    w_t = w_q.t().contiguous()
    got = sp.int8_dense_gelu_quant_split(a, w_q, w_s, b, None, w_t=w_t)
    whole = int8_dense_gelu_quant(a, w_q, w_s, b, w_t=w_t)
    want = sp.int8_dense_gelu_quant_split(a.cpu(), w_q.cpu(), w_s.cpu(),
                                          b.cpu(), None)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])):
        raise AssertionError("dense_gelu_quant_split: not the whole kernel's "
                             "bits on its columns")
    err, frac = assert_codes("dense_gelu_quant_split", got[0].cpu(),
                             got[1].cpu(), *want)
    args = (a, w_q, w_s, b, w_t)
    t = timings(
        lambda *x: sp.int8_dense_gelu_quant_split(*x[:4], None, w_t=x[4]),
        lambda *x: dense_gelu_quant_plain(*x[:4]), None, args,
        big=(0, 1, 4))
    whole_ms = time_ms(lambda *x: int8_dense_gelu_quant(*x[:4], w_t=x[4]),
                       [args], 100)
    b_ms, b_by = bound(nbytes_of(a, w_q, w_s, b) + M * (N + 4),
                       2 * M * H * N, PEAK_INT8)
    line = checks["dense_gelu_quant"]
    out["dense_gelu_quant_split"] = {
        "name": "dense_gelu_quant_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/dense_gelu_quant.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's columns of mlp_in",
        "max_abs_err": err, "code_mismatch_frac": frac, **t,
        "bound_ms": b_ms, "bound_by": b_by, "shape": [M, H, N],
        "whole_same_columns_ms": whole_ms,
        "whole_full_width_ms": line["mlp_in_no_prologue"]["ms"]}

    # B4: out_proj, [2112, 1280 / M] x [1280 / M, 1280], with an all-zero
    # row and a row whose one large value sets its scale.
    M, K = B * NP, H // TP_M
    a, w_q, w_s, _ = dense_inputs(torch, M, K, H, SEED + 23)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    w_t = w_q.t().contiguous()
    got = sp.int8_matmul_fused_split(a, w_q, w_s, None, w_t=w_t)
    whole = int8_matmul_fused(a, w_q, w_s, w_t=w_t)
    want = sp.int8_matmul_fused_split(a.cpu(), w_q.cpu(), w_s.cpu(), None)
    torch.cuda.synchronize()
    if not (torch.equal(got, whole) and torch.equal(got.cpu(), want)):
        raise AssertionError("matmul_fused_split: not bit-equal to the whole "
                             "kernel and its plain version")
    args = (a, w_q, w_s, w_t)
    t = timings(
        lambda a, w_q, w_s, w_t: sp.int8_matmul_fused_split(a, w_q, w_s, None,
                                                            w_t=w_t),
        lambda a, w_q, w_s, w_t: matmul_fused_plain(a, w_q, w_s),
        None, args, big=(0, 1, 3))
    whole_ms = time_ms(lambda a, w_q, w_s, w_t: int8_matmul_fused(
        a, w_q, w_s, w_t=w_t), [args], 100)
    # The function's bytes: a, the kernel's rows and the output.  This
    # design also writes and reads the int32 partial products the
    # collective adds: its own floor (``design_bound_ms``) counts them.
    b_ms, b_by = bound(nbytes_of(a, w_q, w_s, got), 2 * M * K * H,
                       PEAK_INT8)
    d_ms, d_by = bound(nbytes_of(a, w_q, w_s, got) + 2 * M * H * 4,
                       2 * M * K * H, PEAK_INT8)
    line = checks["matmul_fused"]
    out["matmul_fused_split"] = {
        "name": "matmul_fused_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/w8a8_fused.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's rows",
        "max_abs_err": 0.0, **t, "bound_ms": b_ms, "bound_by": b_by,
        "design_bound_ms": d_ms, "design_bound_by": d_by,
        "shape": [M, K, H], "whole_same_columns_ms": whole_ms,
        "whole_full_width_ms": line["ms"]}
    out.update(check_split_kernels_third(torch, checks))
    return out


def check_split_kernels_third(torch, checks):
    """The kernel lines of B14's, B12's and B13's split entries, at
    a rank's shapes of a (1, 2) mesh of v3 in one process, as above: each
    bit-equal to the whole kernel on the same columns, heads or slabs, and
    to (B14) or within the whole kernel's bounds of (B12, B13) its plain
    version; timed beside that whole kernel."""
    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops import split as sp
    from jatsr_torch.ops.attention import (flash_out_plain,
                                           flash_out_weight_t,
                                           gqa_attention_flash_out)
    from jatsr_torch.ops.int8_matmul import (int8_mlp, matmul_prequant_plain,
                                             mlp_plain, quantize_rows)
    from jatsr_torch.ops.quant import w8a8_dot

    out = {}
    # B14 row-parallel: out_proj [2112, 1280 / M] x [1280 / M, 1280] and the
    # unfused mlp_out [2112, 5120 / M] x [5120 / M, 1280], with an all-zero
    # row, one large value and a row below the scale floor.
    M = B * NP
    shapes = {}
    for what, K in (("out_proj", H // TP_M), ("mlp_out", 4 * H // TP_M)):
        a, w_q, w_s, _ = dense_inputs(torch, M, K, H, SEED + 41 + K)
        a[3] = 0.0
        a[5, 7] = 3.0e4
        a[7] *= 1e-12
        w_t = w_q.t().contiguous()
        got = sp.int8_matmul_split(a, w_q, w_s, None, w_t=w_t)
        whole = w8a8_dot(a, w_q, w_s, impl="pallas", w_t=w_t)
        want = sp.int8_matmul_split(a.cpu(), w_q.cpu(), w_s.cpu(), None)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int16), whole.view(torch.int16))
                and torch.equal(got.cpu(), want)):
            raise AssertionError(f"int8_matmul_split ({what}): not "
                                 f"bit-equal to B14 and its plain version")
        args = (a, w_q, w_s, w_t)
        t = timings(
            lambda a, w_q, w_s, w_t: sp.int8_matmul_split(a, w_q, w_s, None,
                                                          w_t=w_t),
            lambda a, w_q, w_s, w_t: matmul_prequant_plain(
                *quantize_rows(a), w_q, w_s),
            None, args, big=(0, 1, 3))
        whole_ms = time_ms(lambda a, w_q, w_s, w_t: w8a8_dot(
            a, w_q, w_s, impl="pallas", w_t=w_t), [args], 100)
        b_ms, b_by = bound(nbytes_of(a, w_q, w_s, got), 2 * M * K * H,
                           PEAK_INT8)
        shapes[what] = {**t, "bound_ms": b_ms, "bound_by": b_by,
                        "shape": [M, K, H], "whole_same_columns_ms": whole_ms}
    line = checks["int8_matmul"]
    out["int8_matmul_split"] = {
        "name": "int8_matmul_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/w8a8_fused.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's rows",
        "max_abs_err": 0.0, **{k: shapes["out_proj"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape",
            "whole_same_columns_ms")},
        "mlp_out": shapes["mlp_out"], "whole_full_width_qkv_ms": line["ms"]}

    # B12 on a rank's heads: qkv [6, 352, 896] (10 q heads, 2 kv heads of
    # 64), keys masked past 345, wo's rows [640, 1280], a non-zero bias.
    hq, hkv, D = 20 // TP_M, 4 // TP_M, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    _, wo_q, wo_s, bo = dense_inputs(torch, 1, hq * D, H, SEED + 45)
    wo_t = flash_out_weight_t(wo_q, hq, D)
    got = sp.gqa_attention_flash_out_split(qkv, cos, sin, wo_q, wo_s, bo, hq,
                                           hkv, None, n_valid=N_VALID,
                                           wo_t=wo_t)
    whole = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                    n_valid=N_VALID, wo_t=wo_t)
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=N_VALID).float()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), whole.view(torch.int16)):
        raise AssertionError("flash_out_split: not B12's bits on its heads")
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    if err > REL_FLASH_OUT * scale:
        raise AssertionError(f"flash_out_split: max abs {err} > "
                             f"{REL_FLASH_OUT} x max |plain| {scale}")
    args = (qkv, cos, sin, wo_q, wo_s, bo, wo_t)
    t = timings(
        lambda x, c, s, q, ws, b, t_: sp.gqa_attention_flash_out_split(
            x, c, s, q, ws, b, hq, hkv, None, n_valid=N_VALID, wo_t=t_),
        lambda x, c, s, q, ws, b, t_: flash_out_plain(
            x, c, s, q, ws, b, hq, hkv, n_valid=N_VALID),
        None, args, big=(0,), reps=200)
    whole_ms = time_ms(lambda x, c, s, q, ws, b, t_: gqa_attention_flash_out(
        x, c, s, q, ws, b, hq, hkv, n_valid=N_VALID, wo_t=t_), [args], 200)
    nbytes = nbytes_of(qkv, cos, sin, wo_q, wo_s, bo) + B * NP * H * 2
    b_ms, b_by = bound(nbytes, 4 * B * hq * NP * N_VALID * D, PEAK_BF16,
                       int8_ops=2 * B * NP * hq * D * H)
    line = checks["flash_out"]
    out["flash_out_split"] = {
        "name": "flash_out_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/flash_qkv.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's heads",
        "max_abs_err": err, "max_abs_plain": scale, **t, "bound_ms": b_ms,
        "bound_by": b_by, "shape": [B, NP, (hq + 2 * hkv) * D, H],
        "whole_same_heads_ms": whole_ms, "whole_full_width_ms": line["ms"]}

    # B13 on rank 0 of TP_M: MLP 5120 (its two whole slabs of 1280) and MLP
    # 1280 (its 640 columns of the one slab), against B13 on the same
    # columns (whose slabs are then the rank's own).
    res = {}
    for N1 in (4 * H, H):
        n1 = N1 // TP_M
        a, w1q, w1s, b1 = dense_inputs(torch, M, H, N1, SEED + 46)
        _, w2q, w2s, b2 = dense_inputs(torch, 1, N1, H, SEED + 47)
        args = (a, w1q[:, :n1].contiguous(), w1s[:, :n1].contiguous(),
                b1[:, :n1].contiguous(), w2q[:n1].contiguous(), w2s, b2)
        kt = {"w1_t": args[1].t().contiguous(),
              "w2_t": args[4].t().contiguous()}
        got = sp.int8_mlp_split(*args, None, rank=0, ranks=TP_M, **kt)
        whole = int8_mlp(*args, **kt)
        want = mlp_plain(*args, group=None, rank=0, ranks=TP_M).float()
        torch.cuda.synchronize()
        if not torch.equal(got, whole):
            raise AssertionError(f"int8_mlp_split (MLP {N1}): not B13's "
                                 f"bits on the same columns")
        frac = (got.float() != want).float().mean().item()
        err = (got.float() - want).abs().max().item()
        if frac > 1e-3 or not torch.allclose(got.float(), want, atol=0.02,
                                             rtol=0.02):
            raise AssertionError(f"int8_mlp_split (MLP {N1}): {frac:.4%} "
                                 f"of the outputs differ from the plain "
                                 f"version, max abs {err}")
        t = timings(lambda *x: sp.int8_mlp_split(*x, None, rank=0,
                                                 ranks=TP_M, **kt),
                    lambda *x: mlp_plain(*x, group=None, rank=0, ranks=TP_M),
                    None, args, big=(0,), plain_reps=5)
        whole_ms = time_ms(lambda *x: int8_mlp(*x, **kt), [args], 100)
        b_ms, b_by = bound(nbytes_of(*args) + M * H * 2, 0.0, PEAK_INT8,
                           int8_ops=4 * M * H * n1)
        res[N1] = {**t, "bound_ms": b_ms, "bound_by": b_by,
                   "max_abs_err": err, "mismatch_frac": frac,
                   "shape": [M, H, n1, H], "whole_same_columns_ms": whole_ms}
    line = checks["int8_mlp"]
    out["int8_mlp_split"] = {
        "name": "int8_mlp_split", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/mlp_full.cu (s8_split.cuh)",
        "replaces": line["replaces"] + ", a rank's columns of w1, rows of w2",
        **{k: res[4 * H][k] for k in (
            "max_abs_err", "mismatch_frac", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "shape", "whole_same_columns_ms")},
        "one_slab_shared": res[H], "whole_full_width_ms": line["ms"]}
    return out


# ---- the fp32 modes (the fp32 path: bench.py's default DiT at
# dtype="float32", which hands B3, B2, B4, B1 and B5 fp32 activations) ------
# B3's fp32 outputs against its plain version: the prologue's fp32
# statistics run in another order, which can move a code by one and its
# row by w/127 of a column, as in bf16 mode; every other output within
# REL_F32 of the plain version's (the same fp32 operations on the same
# codes).  At most 0.5 % of the outputs past it.
REL_F32 = 2.0 ** -20


def fp32_line(bf16_line, extra, source=None):
    """The kernel line of the fp32 mode of ``bf16_line``'s kernel: its name
    with ``_fp32``, its route, source (or ``source``) and TPU kernel, and
    the bf16 mode's ms (``bf16_ms``, timed in this run) beside the fp32
    mode's numbers in ``extra``."""
    return {"name": bf16_line["name"] + "_fp32", "route": "cuda",
            "source": source or bf16_line["source"],
            "replaces": bf16_line["replaces"], "mode": "fp32", **extra,
            "bf16_ms": bf16_line["ms"]}


def check_attention_fp32(torch):
    """flash_qkv's fp32 mode (``csrc/attention_f32.cu``) against its plain
    version at the fp32 path's qkv [6, 352, 1792] fp32 with keys masked
    past 345, and at [6, 345] with none masked: rtol = atol = 1e-5 (fp32
    products and sums in another order); timed beside SDPA in fp32 on the
    same RoPE'd heads with the key mask."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (flash_qkv_plain,
                                           gqa_attention_flash_qkv)

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda")
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    err = 0.0
    for n, n_valid in ((NP, N_VALID), (N_VALID, 0)):
        x = qkv[:, :n].contiguous()
        c, s = cos[:n].contiguous(), sin[:n].contiguous()
        n0 = gqa_attention_flash_qkv.f32_launches
        got = gqa_attention_flash_qkv(x, c, s, hq, hkv, n_valid=n_valid)
        want = flash_qkv_plain(x, c, s, hq, hkv, n_valid=n_valid)
        torch.cuda.synchronize()
        if (got.dtype != torch.float32
                or gqa_attention_flash_qkv.f32_launches != n0 + 1):
            raise AssertionError("flash_qkv fp32: not one fp32-mode launch "
                                 "writing fp32")
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        err = max(err, (got - want).abs().max().item())
    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)
    t = timings(lambda x, c, s, q, k, v: gqa_attention_flash_qkv(
                    x, c, s, hq, hkv, n_valid=N_VALID),
                lambda x, c, s, q, k, v: flash_qkv_plain(
                    x, c, s, hq, hkv, n_valid=N_VALID),
                lambda x, c, s, q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask),
                (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=50)
    nbytes = nbytes_of(qkv, cos, sin) + B * NP * hq * D * 4
    b_ms, b_by = bound(nbytes, 4 * B * hq * NP * N_VALID * D, PEAK_FP32)
    return {"max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, NP, (hq + 2 * hkv) * D], "n_valid": N_VALID}


def prologue_inputs_fp32(torch, N, seed):
    """The fp32 path's prologue inputs: ``prologue_inputs``' with the
    residual stream in fp32, 1e-3 of noise below its bf16 values."""
    x, per, shared, w_q, w_s, b = prologue_inputs(torch, N, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    x = x.float() + 1e-3 * torch.randn(x.shape, generator=gen, device="cuda")
    return x, per, shared, w_q, w_s, b


def check_norm_mod_dot_fp32(torch, norm):
    """norm_mod_dot's fp32 mode (an fp32 x [6, 352, 1280], fp32 qkv out:
    the fp32 prologue, then ``s8_dequant.cuh``'s fp32 GEMM with the bias)
    against its plain version, both norms, per-sample and shared AdaLN
    rows: at most 0.5 % of the outputs past ``REL_F32``."""
    from jatsr_torch.ops.int8_matmul import int8_mm
    from jatsr_torch.ops.prologue import int8_norm_mod_dot, norm_mod_dot_plain

    N, f32 = 1792, torch.float32
    x, per, shared, w_q, w_s, b = prologue_inputs_fp32(torch, N, SEED + 32)
    w_t = w_q.t().contiguous()
    err = far = 0.0
    for kind in ("rms", "layer"):
        for sc, sh in (per, shared):
            n0 = int8_norm_mod_dot.f32_launches
            got = int8_norm_mod_dot(x, sc, sh, w_q, w_s, b, norm=kind,
                                    out_dtype=f32, w_t=w_t)
            want = norm_mod_dot_plain(x, sc, sh, w_q, w_s, b, kind, f32)
            torch.cuda.synchronize()
            if (got.dtype != f32
                    or int8_norm_mod_dot.f32_launches != n0 + 1):
                raise AssertionError("norm_mod_dot fp32: not one fp32-mode "
                                     "launch writing fp32")
            f = ((got - want).abs() > want.abs() * REL_F32).float().mean()
            far = max(far, f.item())
            err = max(err, (got - want).abs().max().item())
            if far > 0.005:
                raise AssertionError(f"norm_mod_dot fp32 {kind}: {far:.4%} "
                                     f"of the outputs past {REL_F32}")

    def library(x, sc, sh, w_q, w_s, b):
        a_q, s = torch_prologue(torch, x, sc, sh, norm)
        return (int8_mm(a_q, w_q).float() * s * w_s + b).reshape(B, NP, N)

    log(f"[kernel] norm_mod_dot fp32: {far:.6%} of the outputs past "
        f"{REL_F32:.3g} of the plain version's")
    sc, sh = shared
    t = timings(lambda *a: int8_norm_mod_dot(*a[:6], norm=norm,
                                             out_dtype=f32, w_t=a[6]),
                lambda *a: norm_mod_dot_plain(*a[:6], norm=norm,
                                              out_dtype=f32),
                lambda *a: library(*a[:6]), (x, sc, sh, w_q, w_s, b, w_t),
                big=(0, 3, 6))
    b_ms, b_by = bound(nbytes_of(x, sc, sh, w_q, w_s, b) + B * NP * N * 4,
                       2 * B * NP * H * N, PEAK_INT8)
    return {"max_abs_err": err, "beyond_rel_frac": far, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [B, NP, H, N]}


def check_norm_mod_gelu_fp32(torch, norm):
    """norm_mod_dense_gelu_quant's fp32 mode (an fp32 x [6, 352, 1280])
    against its plain version, both norms and both row shapes: the bf16
    mode's bound on the codes and scales."""
    from jatsr_torch.ops.int8_matmul import _INV127, _gelu, int8_mm
    from jatsr_torch.ops.prologue import (int8_norm_mod_dense_gelu_quant,
                                          norm_mod_dense_gelu_quant_plain)

    N = 5120
    x, per, shared, w_q, w_s, b = prologue_inputs_fp32(torch, N, SEED + 33)
    w_t = w_q.t().contiguous()
    err = frac = 0.0
    fn = int8_norm_mod_dense_gelu_quant
    for kind in ("rms", "layer"):
        for sc, sh in (per, shared):
            n0 = fn.f32_launches
            got = fn(x, sc, sh, w_q, w_s, b, norm=kind, w_t=w_t)
            want = norm_mod_dense_gelu_quant_plain(x, sc, sh, w_q, w_s, b,
                                                   kind)
            torch.cuda.synchronize()
            if fn.f32_launches != n0 + 1:
                raise AssertionError("norm_mod_dense_gelu_quant fp32: not "
                                     "one fp32-mode launch")
            e, f = assert_codes(f"norm_mod_dense_gelu_quant fp32 {kind}",
                                *got, *want, scale_rtol=2e-3)
            err, frac = max(err, e), max(frac, f)

    def library(x, sc, sh, w_q, w_s, b):
        a_q, s = torch_prologue(torch, x, sc, sh, norm)
        g = _gelu(int8_mm(a_q, w_q).float() * s * w_s + b)
        gs = (g.abs().amax(1, keepdim=True) * _INV127).clamp_min(1e-12)
        return torch.round(g / gs).to(torch.int8), gs

    log(f"[kernel] norm_mod_dense_gelu_quant fp32: {frac:.6%} of the codes "
        f"off by one from the plain version's")
    sc, sh = shared
    t = timings(lambda *a: fn(*a[:6], norm=norm, w_t=a[6]),
                lambda *a: norm_mod_dense_gelu_quant_plain(*a[:6], norm=norm),
                lambda *a: library(*a[:6]), (x, sc, sh, w_q, w_s, b, w_t),
                big=(0, 3, 6))
    b_ms, b_by = bound(nbytes_of(x, sc, sh, w_q, w_s, b) + B * NP * (N + 4),
                       2 * B * NP * H * N, PEAK_INT8)
    return {"max_abs_err": err, "code_mismatch_frac": frac, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [B, NP, H, N]}


def check_dense_gelu_fp32(torch, M, K, N):
    """dense_gelu_quant's fp32 mode (fp32 rows: the fp32 row quant, then
    the same two passes) against its plain version, in both epilogue modes:
    the bf16 mode's bound; timed in the paths' mode."""
    import torch.nn.functional as F

    from jatsr_torch.ops.int8_matmul import (_INV127, dense_gelu_quant_plain,
                                             int8_dense_gelu_quant, int8_mm,
                                             quantize_rows)

    a, w_q, w_s, b = dense_inputs(torch, M, K, N, SEED + 34 + K)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    a = a.float() + 1e-3 * torch.randn(a.shape, generator=gen, device="cuda")
    args = (a, w_q, w_s, b)
    w_t = w_q.t().contiguous()
    err = frac = 0.0
    for fast in (False, True):
        n0 = int8_dense_gelu_quant.f32_launches
        got_q, got_s = int8_dense_gelu_quant(*args, fast_epilogue=fast,
                                             w_t=w_t)
        want_q, want_s = dense_gelu_quant_plain(*args, fast_epilogue=fast)
        torch.cuda.synchronize()
        if int8_dense_gelu_quant.f32_launches != n0 + 1:
            raise AssertionError("dense_gelu_quant fp32: not one fp32-mode "
                                 "launch")
        e, f = assert_codes(f"dense_gelu_quant fp32 {M}x{K}x{N} fast={fast}",
                            got_q, got_s, want_q, want_s)
        err, frac = max(err, e), max(frac, f)

    def library(a, w_q, w_s, b, _):
        a_q, s = quantize_rows(a)
        y = int8_mm(a_q, w_q).float() * s.clamp_min(1e-12) * w_s + b
        g = F.gelu(y, approximate="tanh")
        gs = (g.abs().amax(1, keepdim=True) * _INV127).clamp_min(1e-12)
        return torch.round(g / gs).to(torch.int8), gs

    t = timings(lambda a, w_q, w_s, b, w_t: int8_dense_gelu_quant(
                    a, w_q, w_s, b, w_t=w_t),
                lambda *x: dense_gelu_quant_plain(*x[:4]), library,
                (*args, w_t), big=(0, 1, 4))
    b_ms, b_by = bound(nbytes_of(*args, got_q, got_s), 2 * M * K * N,
                       PEAK_INT8)
    return {"shape": [M, K, N], "max_abs_err": err, "code_mismatch_frac": frac,
            **t, "bound_ms": b_ms, "bound_by": b_by}


def check_fp32_modes(torch, norm, checks):
    """The kernel lines of the five fp32 modes the fp32 path runs, each
    held against its plain version at that path's shapes and timed beside
    its bf16 mode (``checks``' lines, timed in this run): B2, B3, B1 and
    B5 here, B4's from ``check_matmul_fused``."""
    patch = check_dense_gelu_fp32(torch, B * NP, 8192, 512)
    mlp_in = check_dense_gelu_fp32(torch, B * N_VALID, 1280, 5120)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    lines = [
        fp32_line(checks["flash_qkv"], check_attention_fp32(torch),
                  "jatsr_torch/ops/csrc/attention_f32.cu"),
        fp32_line(checks["norm_mod_dot"], check_norm_mod_dot_fp32(torch, norm)),
        fp32_line(checks["matmul_fused"], checks["matmul_fused"].pop("fp32")),
        fp32_line(checks["norm_mod_dense_gelu_quant"],
                  check_norm_mod_gelu_fp32(torch, norm)),
        fp32_line(checks["dense_gelu_quant"],
                  {**{k: patch[k] for k in keys}, "patch_embed": patch,
                   "mlp_in_no_prologue": mlp_in}),
    ]
    return {line["name"]: line for line in lines}


def check_b4_fp32(torch, a, w_q, w_s, w_t):
    """B4's fp32 mode (``w8a8_dot(impl="fused")`` with an fp32 lhs: the row
    quant on fp32 rows, then the GEMM's fp32 instance) at the out_proj
    shape, on ``a`` in fp32 with 1e-3 of noise below its bf16 values (the
    zero row and the large value kept): bit-equal to its plain version, as
    the bf16 mode is (abs, max, multiply, divide and round before an exact
    int32 product, then ``(acc * s) * ws`` in fp32).  ``w8a8_dot`` with the
    fp32 lhs launches B4 once, returns fp32 and equals ``impl="xla"``.
    Timed beside the bf16 mode."""
    from jatsr_torch.ops.int8_matmul import (int8_matmul_fused,
                                             matmul_fused_plain)
    from jatsr_torch.ops.quant import w8a8_dot

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    a32 = a.float() + 1e-3 * torch.randn(a.shape, generator=gen,
                                         device="cuda")
    a32[3] = 0.0
    a32[5, 7] = 3.0e4
    f32 = torch.float32
    got = int8_matmul_fused(a32, w_q, w_s, out_dtype=f32, w_t=w_t)
    want = matmul_fused_plain(a32, w_q, w_s, f32)
    torch.cuda.synchronize()
    if got.dtype != f32 or not torch.equal(got, want):
        raise AssertionError("matmul_fused fp32: not bit-equal to its plain "
                             "version")
    n0 = int8_matmul_fused.launches
    dot = w8a8_dot(a32[None], w_q, w_s, impl="fused", w_t=w_t)
    if (int8_matmul_fused.launches != n0 + 1 or dot.dtype != f32
            or not torch.equal(dot, w8a8_dot(a32[None], w_q, w_s))):
        raise AssertionError("w8a8_dot(fp32 lhs, impl='fused'): not one B4 "
                             "launch, fp32 and equal to impl='xla'")
    log("[kernel] matmul_fused fp32 mode bit-equal to its plain version; "
        "w8a8_dot(fp32 lhs, impl='fused') launches B4, fp32, == impl='xla'")
    t = timings(lambda a, w_q, w_s, w_t: int8_matmul_fused(
                    a, w_q, w_s, out_dtype=f32, w_t=w_t),
                lambda a, w_q, w_s, w_t: matmul_fused_plain(a, w_q, w_s, f32),
                lambda a, w_q, w_s, w_t: w8a8_dot(a, w_q, w_s),
                (a32, w_q, w_s, w_t), big=(0, 1, 3))
    M, K = a32.shape
    b_ms, b_by = bound(nbytes_of(a32, w_q, w_s, got), 2 * M * K * got.shape[1],
                       PEAK_INT8)
    return {"max_abs_err": (got - want).abs().max().item(), **t,
            "bound_ms": b_ms, "bound_by": b_by, "dtypes": ["float32",
                                                           "float32"]}


# ---- the third path's kernels (B12-B14) -------------------------------------
# B12 against its plain version: max abs <= 1e-2 x max |plain|.  The
# kernel's fp32 sums run in another order, which can move a normalised
# weight or a head's output by one bf16 ulp and so a code of the row
# quantisation by one (a step of so * |wo| in the outputs of that row).
def check_split_fp32(torch):
    """flash_split's (B11), gqa_attention's (B15) and
    gqa_attention_grouped's (B16) fp32 modes (``csrc/attention_f32.cu``)
    against their plain versions at the split paths' q [6, 345, 20, 64],
    k/v [6, 345, 4, 64] fp32 (column slices of one fused projection, as
    the model hands them over): rtol = atol = 1e-5, B15 bit-equal to B16;
    B11 also where every real score is negative (its zero keys hold each
    row's max).  Timed on contiguous copies beside fp32 SDPA with the kv
    heads repeated (no mask)."""
    import torch.nn.functional as F

    from jatsr_torch.ops.attention import (flash_split_plain, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_grouped,
                                           gqa_attention_plain)

    hq, hkv, D, N = 20, 4, 64, N_VALID
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda")
    views = (qkv[..., :hq * D].reshape(B, N, hq, D),
             qkv[..., hq * D:(hq + hkv) * D].reshape(B, N, hkv, D),
             qkv[..., (hq + hkv) * D:].reshape(B, N, hkv, D))

    def flat(x):
        return x.reshape(B, N, -1)

    def heads(x):  # [B, N, h, D] -> [B, hq, N, D], kv heads repeated
        return x.transpose(1, 2).repeat_interleave(
            hq // x.shape[2], 1).contiguous()

    kernels = {
        "flash_split": (
            lambda q, k, v, *_: gqa_attention_flash(flat(q), flat(k),
                                                    flat(v), hq, hkv),
            lambda q, k, v, *_: flash_split_plain(flat(q), flat(k), flat(v),
                                                  hq, hkv), gqa_attention_flash),
        "gqa_attention": (
            lambda q, k, v, *_: gqa_attention(q, k, v),
            lambda q, k, v, *_: gqa_attention_plain(q, k, v), gqa_attention),
        "gqa_attention_grouped": (
            lambda q, k, v, *_: gqa_attention_grouped(q, k, v),
            lambda q, k, v, *_: gqa_attention_plain(q, k, v),
            gqa_attention_grouped),
    }
    q, k, v = (x.contiguous() for x in views)
    args = (q, k, v, heads(q), heads(k), heads(v))
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    b_ms, b_by = bound(nbytes, 4 * B * hq * N * N * D, PEAK_FP32)
    out, got = {}, {}
    for name, (kernel, plain, fn) in kernels.items():
        n0 = fn.f32_launches
        got[name] = kernel(*views)
        want = plain(*views)
        torch.cuda.synchronize()
        if got[name].dtype != torch.float32 or fn.f32_launches != n0 + 1:
            raise AssertionError(f"{name} fp32: not one fp32-mode launch "
                                 f"writing fp32")
        torch.testing.assert_close(got[name], want, atol=1e-5, rtol=1e-5)
        t = timings(kernel, plain,
                    lambda *a: F.scaled_dot_product_attention(*a[3:]), args,
                    big=(0, 1, 2, 3, 4, 5), reps=20, plain_reps=5)
        out[name] = {"max_abs_err": (got[name] - want).abs().max().item(),
                     **t, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": [B, N, hq, hkv, D]}
    if not torch.equal(got["gqa_attention"], got["gqa_attention_grouped"]):
        raise AssertionError("gqa_attention and gqa_attention_grouped differ "
                             "in fp32 mode: they must be bit-equal")
    qp, kp = views[0].abs() * 0.5, views[1].abs() * -0.5
    vp = views[2] * 0.5 + 1
    got = gqa_attention_flash(flat(qp), flat(kp), flat(vp), hq, hkv)
    want = flash_split_plain(flat(qp), flat(kp), flat(vp), hq, hkv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    out["flash_split"]["pad_keys_max_abs_err"] = (got - want).abs().max(
        ).item()
    return out


def check_flash_out_fp32(torch):
    """flash_out's fp32 mode (B12: the fp32 attention into a scratch, the
    fp32 row quant, the s8 GEMM with the bias writing fp32) against its
    plain version at qkv [6, 352, 1792] fp32, keys masked past 345, wo
    [1280, 1280] K-major: max abs <= REL_FLASH_OUT x max |plain| (its bf16
    mode's bound: a head output one fp32 ulp apart can move a code); then
    with an identity out projection, whose output is o_q * so, the codes
    equal to the plain version's but for <= 0.5 % off by one.
    Timed beside fp32 SDPA with the key mask, the torch row quant,
    ``_int_mm`` and the epilogue; the bound counts the attention's two
    products at the fp32 peak and the out projection at the int8 one."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (flash_out_plain,
                                           flash_out_weight_t,
                                           gqa_attention_flash_out)
    from jatsr_torch.ops.int8_matmul import quantize_rows

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda")
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    _, wo_q, wo_s, bo = dense_inputs(torch, 1, hq * D, H, SEED + 52)
    wo_t = flash_out_weight_t(wo_q, hq, D)
    f = gqa_attention_flash_out
    n0 = f.f32_launches
    got = f(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv, n_valid=N_VALID,
            wo_t=wo_t)
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=N_VALID)
    torch.cuda.synchronize()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if (got.dtype != torch.float32 or f.f32_launches != n0 + 1
            or not bool(torch.isfinite(got).all())
            or err > REL_FLASH_OUT * scale):
        raise AssertionError(f"flash_out fp32: max abs {err} against max "
                             f"|plain| {scale}, or not one fp32-mode launch")
    # The codes themselves, read back through an identity out projection
    # (out = o_q * so): the row quant hides o's precision from the outputs
    # above, where a head output in less than fp32 still passes, but it
    # flips many more codes than assert_codes's 0.5 %.
    eye = torch.eye(hq * D, dtype=torch.int8, device="cuda")
    ones = torch.ones((1, hq * D), device="cuda")
    zeros = torch.zeros_like(ones)
    got = f(qkv, cos, sin, eye, ones, zeros, hq, hkv, n_valid=N_VALID,
            wo_t=flash_out_weight_t(eye, hq, D))
    want = flash_out_plain(qkv, cos, sin, eye, ones, zeros, hq, hkv,
                           n_valid=N_VALID)
    torch.cuda.synchronize()
    _, frac = assert_codes("flash_out fp32 (identity out projection)",
                           *identity_codes(got), *identity_codes(want))
    log(f"[kernel] flash_out fp32: {frac:.6%} of the codes off by one from "
        f"the plain version's (identity out projection)")
    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)

    def library(x, c, s, q, k, v):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o_q, so = quantize_rows(o.transpose(1, 2).reshape(B * NP, hq * D))
        return torch._int_mm(o_q, wo_q).float() * so.clamp_min(1e-12) * wo_s + bo

    t = timings(lambda x, c, s, *_: f(x, c, s, wo_q, wo_s, bo, hq, hkv,
                                      n_valid=N_VALID, wo_t=wo_t),
                lambda x, c, s, *_: flash_out_plain(
                    x, c, s, wo_q, wo_s, bo, hq, hkv, n_valid=N_VALID),
                library, (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=20,
                plain_reps=5)
    nbytes = nbytes_of(qkv, cos, sin, wo_q, wo_s, bo) + B * NP * H * 4
    b_ms, b_by = bound(nbytes, 4 * B * hq * NP * N_VALID * D, PEAK_FP32,
                       int8_ops=2 * B * NP * hq * D * H)
    return {"max_abs_err": err, "max_abs_plain": scale,
            "code_mismatch_frac": frac, **t, "bound_ms": b_ms,
            "bound_by": b_by, "shape": [B, NP, (hq + 2 * hkv) * D, H],
            "n_valid": N_VALID}


def check_int8_mlp_fp32(torch):
    """int8_mlp's fp32 mode (B13: the reciprocal row quant on fp32 rows,
    the rest as in bf16 mode, bf16 out) against its plain version at
    [2112, 1280] fp32 x [1280, 5120] x [5120, 1280]: its bf16 mode's
    bounds.  Timed beside the two ``_int_mm`` chains with an fp32 first row
    quant."""
    from jatsr_torch.ops.int8_matmul import (_INV127, _gelu, _pick_slabs,
                                             int8_mlp, mlp_plain,
                                             quantize_rows)

    M, N1 = B * NP, 4 * H
    a, w1q, w1s, b1 = dense_inputs(torch, M, H, N1, SEED + 53)
    _, w2q, w2s, b2 = dense_inputs(torch, 1, N1, H, SEED + 54)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 55)
    a = a.float() + 1e-3 * torch.randn(a.shape, generator=gen, device="cuda")
    args = (a, w1q, w1s, b1, w2q, w2s, b2)
    kt = {"w1_t": w1q.t().contiguous(), "w2_t": w2q.t().contiguous()}
    n0 = int8_mlp.f32_launches
    got = int8_mlp(*args, **kt).float()
    want = mlp_plain(*args).float()
    torch.cuda.synchronize()
    frac = (got != want).float().mean().item()
    err = (got - want).abs().max().item()
    if (int8_mlp.f32_launches != n0 + 1 or frac > 1e-3
            or not torch.allclose(got, want, atol=0.02, rtol=0.02)):
        raise AssertionError(f"int8_mlp fp32: {frac:.4%} of the outputs "
                             f"differ, max abs {err}")
    n, slab = _pick_slabs(N1), N1 // _pick_slabs(N1)

    def library(a, w1q, w1s, b1, w2q, w2s, b2):
        a_q, s = quantize_rows(a)
        g = _gelu(torch._int_mm(a_q, w1q).float() * s.clamp_min(1e-12) * w1s
                  + b1).bfloat16().float().reshape(M, n, slab)
        gs = (g.abs().amax(-1, keepdim=True) * _INV127).clamp_min(1e-12)
        g_q = torch.round(g / gs).to(torch.int8).transpose(0, 1).contiguous()
        acc = sum(torch._int_mm(g_q[j], w2q[j * slab:(j + 1) * slab]).float()
                  * gs[:, j] for j in range(n))
        return (acc * w2s + b2).bfloat16()

    t = timings(lambda *x: int8_mlp(*x, **kt), mlp_plain, library, args,
                big=(0,), plain_reps=5)
    b_ms, b_by = bound(nbytes_of(*args) + M * H * 2, 0.0, PEAK_INT8,
                       int8_ops=4 * M * H * N1)
    return {"max_abs_err": err, "mismatch_frac": frac, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [M, H, N1, H]}


def check_int8_qk_fp32(torch):
    """flash_qkv's int8 value product in fp32 mode (the codes of the fp32
    v, then fp32 scores and the s8 value product) against its plain version
    at the main path's qkv [6, 352, 1792] fp32 (keys masked past 345, a
    padded row holding every v column's absmax) and at [6, 345]: atol =
    rtol = 1e-2, at most 1 % of the outputs more than 1e-4 apart, the codes
    and scales bit-equal to ``v_codes_plain``.  Timed beside fp32 SDPA with
    the key mask; the bound counts the score product at the fp32 peak and
    the value product at the int8 one."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_row_view, _v_codes,
                                           flash_qkv_plain,
                                           gqa_attention_flash_qkv,
                                           v_codes_plain)

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 56)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda")
    qkv[:, N_VALID + 3, (hq + hkv) * D:] = 6.0
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    f = gqa_attention_flash_qkv
    err = 0.0
    for n, n_valid in ((NP, N_VALID), (N_VALID, 0)):
        x = qkv[:, :n].contiguous()
        c, s = cos[:n].contiguous(), sin[:n].contiguous()
        n0 = f.int8_qk_f32_launches
        got = f(x, c, s, hq, hkv, n_valid=n_valid, int8_qk=True)
        want = flash_qkv_plain(x, c, s, hq, hkv, n_valid=n_valid,
                               int8_qk=True)
        v, row = _row_view(x[..., (hq + hkv) * D:])
        codes, sv = _v_codes(v, row, hkv, D, 384)
        want_codes, want_sv = v_codes_plain(x[..., (hq + hkv) * D:], hkv, 384)
        torch.cuda.synchronize()
        far = ((got - want).abs() > 1e-4).float().mean().item()
        if (got.dtype != torch.float32 or f.int8_qk_f32_launches != n0 + 1
                or far > 1e-2 or not torch.equal(codes, want_codes)
                or not torch.equal(sv, want_sv)):
            raise AssertionError(f"flash_qkv int8_qk fp32 at n {n}: "
                                 f"{far:.4%} of the outputs past 1e-4, or "
                                 f"codes differ, or not one fp32-mode launch")
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
        err = max(err, (got - want).abs().max().item())
    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)
    t = timings(lambda x, c, s, q, k, v: f(x, c, s, hq, hkv, n_valid=N_VALID,
                                           int8_qk=True),
                lambda x, c, s, q, k, v: flash_qkv_plain(
                    x, c, s, hq, hkv, n_valid=N_VALID, int8_qk=True),
                lambda x, c, s, q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask),
                (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=20,
                plain_reps=5)
    views = [_row_view(x[..., (hq + hkv) * D:]) for x in
             [qkv.clone() for _ in range(rotations(qkv.nbytes))]]
    t["codes_ms"] = time_ms(lambda v, row: _v_codes(v, row, hkv, D, 384),
                            views, 200)
    nbytes = nbytes_of(qkv, cos, sin) + B * NP * hq * D * 4
    prod = 2 * B * hq * NP * N_VALID * D  # each product, the valid keys
    b_ms, b_by = bound(nbytes, prod, PEAK_FP32, int8_ops=prod)
    return {"max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, NP, (hq + 2 * hkv) * D], "n_valid": N_VALID}


def check_fp32_slice(torch, checks):
    """The kernel lines of the six fp32 modes the fp32 paths of this slice
    run (B11, B15, B16, B12, B13, B2's int8_qk), each held against its
    plain version at its path's shapes and timed beside its bf16 mode
    (``checks``' lines, timed in this run)."""
    f32 = "jatsr_torch/ops/csrc/attention_f32.cu"
    split = check_split_fp32(torch)
    lines = [fp32_line(checks[k], split[k], f32) for k in (
                 "flash_split", "gqa_attention", "gqa_attention_grouped")]
    lines += [fp32_line(checks["flash_out"], check_flash_out_fp32(torch), f32),
              fp32_line(checks["int8_mlp"], check_int8_mlp_fp32(torch)),
              fp32_line(checks["flash_qkv_int8_qk"],
                        check_int8_qk_fp32(torch), f32)]
    return {line["name"]: line for line in lines}


REL_FLASH_OUT = 1e-2


def check_flash_out(torch):
    """flash_out (B12) against its plain version at qkv [6, 352, 1792],
    keys masked past 345, wo [1280, 1280] with a non-zero bias; its GEMM
    reads the weight K-major (``wo_t``), made once, as the DiT makes it."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (flash_out_plain,
                                           flash_out_weight_t,
                                           gqa_attention_flash_out)
    from jatsr_torch.ops.int8_matmul import quantize_rows

    hq, hkv, D = 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    qkv = torch.randn((B, NP, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(NP, D, device="cuda")
    _, wo_q, wo_s, bo = dense_inputs(torch, 1, hq * D, H, SEED + 12)
    wo_t = flash_out_weight_t(wo_q, hq, D)
    got = gqa_attention_flash_out(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                                  n_valid=N_VALID, wo_t=wo_t).float()
    want = flash_out_plain(qkv, cos, sin, wo_q, wo_s, bo, hq, hkv,
                           n_valid=N_VALID).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err, scale = diff.max().item(), want.abs().max().item()
    far = (diff > want.abs() * 2.0 ** -7).float().mean().item()
    if not bool(torch.isfinite(got).all()) or err > REL_FLASH_OUT * scale:
        raise AssertionError(f"flash_out: max abs {err} > {REL_FLASH_OUT} x "
                             f"max |plain| {scale}")
    q, k, v, mask = sdpa_inputs(torch, qkv, cos, sin, hq, hkv)

    def library(x, c, s, q, k, v):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        o_q, so = quantize_rows(o.transpose(1, 2).reshape(B * NP, hq * D))
        y = torch._int_mm(o_q, wo_q).float() * so.clamp_min(1e-12) * wo_s + bo
        return y.bfloat16()

    t = timings(lambda x, c, s, *_: gqa_attention_flash_out(
                    x, c, s, wo_q, wo_s, bo, hq, hkv, n_valid=N_VALID,
                    wo_t=wo_t),
                lambda x, c, s, *_: flash_out_plain(
                    x, c, s, wo_q, wo_s, bo, hq, hkv, n_valid=N_VALID),
                library, (qkv, cos, sin, q, k, v), big=(0, 3, 4, 5), reps=200)
    nbytes = nbytes_of(qkv, cos, sin, wo_q, wo_s, bo) + B * NP * H * 2
    b_ms, b_by = bound(nbytes, 4 * B * hq * NP * N_VALID * D, PEAK_BF16,
                       int8_ops=2 * B * NP * hq * D * H)
    return {"name": "flash_out", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/flash_qkv.cu",
            "replaces": "ops/attention.py:534 (JAX package, "
                        "gqa_attention_flash_out; pallas_call :565)",
            "max_abs_err": err, "max_abs_plain": scale,
            "beyond_1ulp_frac": far, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": [B, NP, (hq + 2 * hkv) * D, H], "n_valid": N_VALID}


def check_int8_mlp(torch):
    """int8_mlp (B13) against its plain version at [2112, 1280] x [1280,
    5120] x [5120, 1280] (four slabs of 1280): equal but for <= 0.1 % of
    the outputs, each within 0.02 absolute plus 0.02 relative (tanhf/expf
    against PyTorch's can move a bf16 g, and so a code, by one)."""
    from jatsr_torch.ops.int8_matmul import (_INV127, _gelu, _pick_slabs,
                                             int8_mlp, mlp_plain,
                                             quantize_rows)

    M, N1 = B * NP, 4 * H
    a, w1q, w1s, b1 = dense_inputs(torch, M, H, N1, SEED + 13)
    _, w2q, w2s, b2 = dense_inputs(torch, 1, N1, H, SEED + 14)
    args = (a, w1q, w1s, b1, w2q, w2s, b2)
    # The K-major copies of both weights, made once, as the DiT makes them.
    kt = {"w1_t": w1q.t().contiguous(), "w2_t": w2q.t().contiguous()}
    got = int8_mlp(*args, **kt).float()
    want = mlp_plain(*args).float()
    torch.cuda.synchronize()
    frac = (got != want).float().mean().item()
    err = (got - want).abs().max().item()
    if frac > 1e-3 or not torch.allclose(got, want, atol=0.02, rtol=0.02):
        raise AssertionError(f"int8_mlp: {frac:.4%} of the outputs differ, "
                             f"max abs {err}")
    n, slab = _pick_slabs(N1), N1 // _pick_slabs(N1)

    def library(a, w1q, w1s, b1, w2q, w2s, b2):
        a_q, s = quantize_rows(a)
        g = _gelu(torch._int_mm(a_q, w1q).float() * s.clamp_min(1e-12) * w1s
                  + b1).bfloat16().float().reshape(M, n, slab)
        gs = (g.abs().amax(-1, keepdim=True) * _INV127).clamp_min(1e-12)
        g_q = torch.round(g / gs).to(torch.int8).transpose(0, 1).contiguous()
        acc = sum(torch._int_mm(g_q[j], w2q[j * slab:(j + 1) * slab]).float()
                  * gs[:, j] for j in range(n))
        return (acc * w2s + b2).bfloat16()

    t = timings(lambda *x: int8_mlp(*x, **kt), mlp_plain, library, args,
                big=(0,), plain_reps=5)
    b_ms, b_by = bound(nbytes_of(*args) + M * H * 2, 0.0, PEAK_INT8,
                       int8_ops=4 * M * H * N1)
    return {"name": "int8_mlp", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/mlp_full.cu",
            "replaces": "ops/int8_matmul.py:691 (JAX package, int8_mlp; "
                        "pallas_call :721)",
            "max_abs_err": err, "mismatch_frac": frac, **t,
            "bound_ms": b_ms, "bound_by": b_by, "shape": [M, H, N1, H],
            "slabs": n}


def check_int8_matmul(torch):
    """int8_matmul (B14) at the qkv product [2112, 1280] x [1280, 1792] on
    the weight K-major (``w_t``, made once, as the DiT makes it), in bf16
    and fp32 output: bit-equal to its plain version.  Then
    ``w8a8_dot(impl="pallas")``, the row-quant launch and B14 started
    behind it under programmatic stream serialisation, bit-equal to
    ``impl="xla"``, with an all-zero row and a row whose max|a| * (1/127)
    is below 1e-12 (there the floored and unfloored scales differ)."""
    from jatsr_torch.ops.int8_matmul import (int8_matmul,
                                             int8_quantize_rows,
                                             matmul_prequant_plain,
                                             quantize_rows)
    from jatsr_torch.ops.quant import w8a8_dot

    M, N = B * NP, 1792
    a, w_q, w_s, _ = dense_inputs(torch, M, H, N, SEED + 15)
    a[3] = 0.0
    a[7] *= 1e-12
    w_t = w_q.t().contiguous()
    a_q, a_s = quantize_rows(a)
    for dt in (torch.bfloat16, torch.float32):
        got = int8_matmul(a_q, a_s, w_q, w_s, out_dtype=dt, w_t=w_t)
        want = matmul_prequant_plain(a_q, a_s, w_q, w_s, dt)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got.dtype != dt:
            raise AssertionError(f"int8_matmul: not bit-equal to its plain "
                                 f"version in {dt}")
    got = w8a8_dot(a, w_q, w_s, impl="pallas", w_t=w_t)
    want = w8a8_dot(a, w_q, w_s, impl="xla")
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("w8a8_dot(impl='pallas'): not bit-equal to "
                             "impl='xla'")
    log("[kernel] int8_matmul bit-equal to its plain version (bf16, fp32); "
        "w8a8_dot pallas == xla, bit for bit")

    def library(a_q, a_s, w_q, w_s, _):
        return (torch._int_mm(a_q, w_q).float() * a_s * w_s).bfloat16()

    t = timings(lambda a_q, a_s, w_q, w_s, w_t: int8_matmul(
                    a_q, a_s, w_q, w_s, w_t=w_t),
                lambda a_q, a_s, w_q, w_s, _: matmul_prequant_plain(
                    a_q, a_s, w_q, w_s),
                library, (a_q, a_s, w_q, w_s, w_t), big=(0, 4))
    sets = [(a.clone(),) for _ in range(rotations(a.nbytes + w_t.nbytes))]
    whole = {"quant_ms": time_ms(int8_quantize_rows, sets, 100),
             "w8a8_dot_pallas_ms": time_ms(lambda x: w8a8_dot(
                 x, w_q, w_s, impl="pallas", w_t=w_t), sets, 100)}
    b_ms, b_by = bound(nbytes_of(a_q, a_s, w_q, w_s, got), 2 * M * H * N,
                       PEAK_INT8)
    return {"name": "int8_matmul", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/w8a8_fused.cu",
            "replaces": "ops/int8_matmul.py:757 (JAX package, int8_matmul; "
                        "pallas_call :794)",
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            **t, "bound_ms": b_ms, "bound_by": b_by, "shape": [M, H, N],
            **whole}


# ---- the fused decode's kernels (B6-B9) ------------------------------------
# Shapes of one 2884-frame decode segment: (Cin, Cout, stride, T in) of the
# upsamples, and (C, T) of the residual stages behind them.
UPSAMPLES = [(1536, 768, 8, DECODE_L), (768, 384, 8, DECODE_L * 8),
             (384, 192, 4, DECODE_L * 64), (192, 96, 2, DECODE_L * 256)]
STAGES = [(384, DECODE_L * 64), (192, DECODE_L * 256),
          (96, DECODE_L * 512)]
# Max abs error against the plain version, as a share of max |plain|.  The
# transposes: the same bf16 products with fp32 sums in another order, and
# ``sinf`` against PyTorch's ``sin``, which can move one bf16 input by one
# ulp.  The residual units also round an intermediate h to bf16 between
# their two products: a sum in another order moves some h by one bf16 ulp,
# which shifts an output by ulp(h) * |w1| (~1e-3 of max |out| at |h| ~ 3),
# and three chained units carry it on.  Measured on the card: 1.08e-3 at
# stage 2's B6 (1.4e8 outputs); bound 4e-3.
REL_TRANSPOSE, REL_UNITS = 1e-3, 4e-3


def dac_check(torch, what, kernel, plain, library, args, big, nbytes, ops,
              rel):
    """One DAC kernel at one shape against its plain version (max abs error
    <= ``rel`` x max |plain|), then kernel, plain and library ms."""
    from jatsr_torch.ops import dac_kernels as dk

    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    scale = want.abs().max().item()
    beyond = (diff > 1e-3 * scale).float().mean().item()
    if not bool(torch.isfinite(got).all()) or err > rel * scale:
        raise AssertionError(f"{what}: max abs error {err} > {rel} x "
                             f"max |plain| {scale}")
    mode = {}
    if dk._snake_b16_mode():
        mode = snake_mode_shows(torch, what, kernel, plain, args, got,
                                diff.mean().item())
    del got, want, diff
    t = timings(kernel, plain, library, args, big, reps=20, plain_reps=3)
    b_ms, b_by = bound(nbytes, ops, PEAK_BF16)
    return {"max_abs_err": err, "max_abs_plain": scale,
            "beyond_1e-3_frac": beyond, **mode, **t, "bound_ms": b_ms,
            "bound_by": b_by}


# In bf16-snake mode a DAC kernel's output must show the mode: the same
# call in fp32 mode gives another output, and its mean abs error from the
# fp32-mode plain version is at least SNAKE_GAP times that from the
# bf16-mode one.  This script's run on an H100 (700 W): 3.2x at B6's C 384
# stage (the bf16 h between its products spreads the error of a sum's
# order over whole rows), 6.2x and 21.6x at C 192 and 96, 605x for B9 and
# over 1000x for the transposes.
SNAKE_GAP = 2.0


def snake_mode_shows(torch, what, kernel, plain, args, got, mean):
    """``got``, ``kernel(*args)`` in bf16-snake mode, ``mean`` abs error
    from its plain version, against the kernel and the plain version in
    fp32 mode on the same inputs (see ``SNAKE_GAP``)."""
    from jatsr_torch.ops import dac_kernels as dk

    dk.set_snake_compute_dtype("float32")
    try:
        got32, want32 = kernel(*args), plain(*args)
    finally:
        dk.set_snake_compute_dtype("bfloat16")
    torch.cuda.synchronize()
    other = (got - want32).abs().mean().item()
    moved = (got - got32).abs().max().item()
    log(f"[kernel] {what} bf16 snake: mean abs {mean:.3e} from the "
        f"bf16-mode plain version, {other:.3e} from the fp32-mode one; max "
        f"abs {moved:.3e} from the fp32-mode kernel")
    if moved == 0.0 or other < SNAKE_GAP * mean:
        raise AssertionError(f"{what}: the bf16 snake does not show "
                             f"(fp32-mode kernel {moved} away, mean abs "
                             f"{other} from the fp32-mode plain version "
                             f"against {mean})")
    return {"mean_abs_err": mean, "fp32_mode_plain_mean_abs": other,
            "fp32_mode_kernel_max_abs": moved}


def per_launch(name, source, replaces, shapes):
    """A kernel's line from its checks at several shapes of the path, each
    launched equally often there: mean ms per launch, and so on."""
    n = len(shapes)
    top = max(shapes, key=lambda s: s["bound_ms"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            **{k: sum(s[k] for s in shapes) / n
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": top["bound_by"], "shapes": shapes}


def unit_inputs(torch, B, T, C, units, seed):
    """x ~ N(0, 1); weights as the DAC initializer draws them (uniform
    +-1/sqrt(fan_in)), in the JAX layout, packed to bf16 as the decoder
    packs them; biases N(0, 0.1^2); snake alphas in [0.5, 1.5)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uni(shape, lim):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
                * lim)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return (normal((B, T, C), 1.0),
            uni((units, 7, C, C), (7 * C) ** -0.5).bfloat16(),
            normal((units, C), 0.1),
            uni((units, C, C), C ** -0.5).bfloat16(), normal((units, C), 0.1),
            torch.rand((units, C), generator=gen, device="cuda") + 0.5,
            torch.rand((units, C), generator=gen, device="cuda") + 0.5)


def library_units(torch, x, w7s, b7s, w1s, b1s, a1s, a2s, dils):
    """The yardstick of B6/B9: the units as one PyTorch chain of bf16
    cuDNN convolutions on [B, C, T] (weights in PyTorch's layout)."""
    import torch.nn.functional as F

    from jatsr_torch.ops.dac_kernels import snake_b16

    x = x.transpose(1, 2)
    for u, d in enumerate(dils):
        y = snake_b16(x, a1s[u][:, None])
        y = F.conv1d(y, w7s[u], b7s[u], padding=3 * d, dilation=d)
        y = F.conv1d(snake_b16(y, a2s[u][:, None]), w1s[u], b1s[u])
        x = x + y.float()
    return x.transpose(1, 2)


def torch_unit_weights(w7s, b7s, w1s, b1s):
    """JAX-layout unit weights in PyTorch's conv layout, bf16."""
    return (w7s.permute(0, 3, 2, 1).contiguous(), b7s.bfloat16(),
            w1s.transpose(1, 2)[..., None].contiguous(), b1s.bfloat16())


def check_res(torch, B, T, C, dils):
    """B6 (three units) or B9 (one unit) at [B, T, C]."""
    from jatsr_torch.ops import dac_kernels as dk

    units = len(dils)
    x, w7s, b7s, w1s, b1s, a1s, a2s = unit_inputs(torch, B, T, C, units,
                                                  SEED + C + units)
    tw = torch_unit_weights(w7s, b7s, w1s, b1s)
    if units == 3:
        def kernel(x, *w):
            return dk.res_stage_fused(x, w7s, b7s, w1s, b1s, a1s, a2s)

        def plain(x, *w):
            return dk.res_stage_plain(x, w7s, b7s, w1s, b1s, a1s, a2s)
    else:
        def kernel(x, *w):
            return dk.res_unit_fused(x, w7s[0], b7s[0], w1s[0], b1s[0],
                                     a1s[0], a2s[0], dilation=dils[0])

        def plain(x, *w):
            return dk.res_unit_plain(x, w7s[0], b7s[0], w1s[0], b1s[0],
                                     a1s[0], a2s[0], dils[0])

    def library(x, w7t, b7t, w1t, b1t):
        return library_units(torch, x, w7t, b7t, w1t, b1t, a1s, a2s, dils)

    nbytes = 2 * x.nbytes + nbytes_of(w7s, b7s, w1s, b1s, a1s, a2s)
    r = dac_check(torch, f"res units {dils} [{B}, {T}, {C}]", kernel, plain,
                  library, (x, *tw), big=(0,), nbytes=nbytes,
                  ops=units * 2 * 8 * C * C * B * T, rel=REL_UNITS)
    return {"shape": [B, T, C], "dilations": list(dils), **r}


ODD_T = 1001  # B7 beside the path's shapes: batch 2, an odd T


def transpose_inputs(torch, Bn, T, ci, co, s, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Bn, T, ci), generator=gen, device="cuda")
    w = ((torch.rand((2 * s, ci, co), generator=gen, device="cuda") * 2 - 1)
         * (2 * s * ci) ** -0.5).bfloat16()
    b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
    a = torch.rand((ci,), generator=gen, device="cuda") + 0.5
    return x, w, b, a


def check_transpose(torch, ci, co, s, T):
    """B7 (Cin in the resident table) or B8 (stage 0) at [1, T, Cin], the
    path's shape; B7 also at batch 2 and T = ``ODD_T``.  Timed apart: B8's
    kernel alone on the input its wrapper has snaked, and stage 1's two
    launches (B7's snake pass, then B8's kernel); B7 at stages 2 and 3 is
    one launch."""
    import torch.nn.functional as F

    from jatsr_torch.ops import _build
    from jatsr_torch.ops import dac_kernels as dk

    x, w, b, a = transpose_inputs(torch, 1, T, ci, co, s, SEED + ci)
    kw = dict(stride=s, padding=(s + 1) // 2, output_padding=s % 2)
    fused = ci in dk._TBLK_TR
    entry = (dk.snake_conv_transpose_fused if fused
             else dk.snake_conv_transpose_streamed)
    wt, bt = w.permute(1, 2, 0).contiguous(), b.bfloat16()

    def library(x, wt, bt):
        return F.conv_transpose1d(dk.snake_b16(x, a).transpose(1, 2), wt, bt,
                                  **kw).transpose(1, 2)

    m_out = (T - 1) * s - 2 * kw["padding"] + 2 * s + s % 2
    split = {}
    if not fused or ci > dk._TR_MAX_CIN:
        # B8's kernel alone, on the input snaked before it.
        y = [dk.snake_b16(x, a) for _ in range(rotations(x.nbytes // 2))]
        split["gemm_ms"] = time_ms(
            lambda y: dk._launch_stream(y, w, b, s, kw["padding"],
                                        kw["output_padding"]),
            [(t,) for t in y], 20)
        del y
    if fused and ci > dk._TR_MAX_CIN:
        # Stage 1's snake pass alone.
        lib, plan = dk._tr_lib(), dk._tr_plan(1, T, ci, co, s,
                                               dk._sm_count(0))
        y = torch.empty((1, T, ci), dtype=torch.bfloat16, device="cuda")

        def snake(x):
            _build.check(lib, lib.snake_b16(
                x.data_ptr(), a.data_ptr(), y.data_ptr(), x.numel(), ci,
                plan.snake_blocks, dk._snake_b16_mode(),
                _build.stream_ptr(x.device)), "snake_b16")

        split["snake_ms"] = time_ms(
            snake, [(x.clone(),) for _ in range(rotations(x.nbytes))], 20)
        del y
    r = dac_check(torch, f"transpose {ci}->{co} s{s} T {T}",
                  lambda x, *_: entry(x, w, b, a, **kw),
                  lambda x, *_: dk.snake_conv_transpose_plain(x, w, b, a,
                                                              **kw),
                  library, (x, wt, bt), big=(0,),
                  nbytes=x.nbytes + nbytes_of(w, b, a) + m_out * co * 4,
                  ops=4 * ci * co * m_out, rel=REL_TRANSPOSE)
    if fused:
        xo, wo, bo, ao = transpose_inputs(torch, 2, ODD_T, ci, co, s,
                                          SEED + ci + 1)
        got = entry(xo, wo, bo, ao, **kw)
        want = dk.snake_conv_transpose_plain(xo, wo, bo, ao, **kw)
        torch.cuda.synchronize()
        err, scale = ((got - want).abs().max().item(),
                      want.abs().max().item())
        if not bool(torch.isfinite(got).all()) or err > REL_TRANSPOSE * scale:
            raise AssertionError(f"transpose {ci}->{co} s{s} [2, {ODD_T}]: "
                                 f"max abs error {err} > {REL_TRANSPOSE} x "
                                 f"max |plain| {scale}")
        split[f"batch_2_t_{ODD_T}"] = {"max_abs_err": err,
                                       "max_abs_plain": scale}
    return {"shape": [1, T, ci, co], "stride": s, **r, **split}


def check_dac_kernels(torch):
    """The four DAC kernels at the fused decode's shapes (B9 where the
    decoder would take it: C 192, T 1024, dilation 9)."""
    replaces = "ops/dac_kernels.py:{} (JAX package, {}; pallas_call :{})"
    ups = [check_transpose(torch, *u) for u in UPSAMPLES]
    return {
        "snake_conv_transpose_streamed": per_launch(
            "snake_conv_transpose_streamed",
            "jatsr_torch/ops/csrc/snake_tr_stream.cu",
            replaces.format(569, "_snake_conv_transpose_streamed", 604),
            ups[:1]),
        "snake_conv_transpose_fused": per_launch(
            "snake_conv_transpose_fused", "jatsr_torch/ops/csrc/snake_tr.cu",
            replaces.format(486, "snake_conv_transpose_fused", 533),
            ups[1:]),
        "res_stage_fused": per_launch(
            "res_stage_fused", "jatsr_torch/ops/csrc/dac_res.cu",
            replaces.format(245, "res_stage_fused", 289),
            [check_res(torch, 1, T, C, (1, 3, 9)) for C, T in STAGES]),
        "res_unit_fused": per_launch(
            "res_unit_fused", "jatsr_torch/ops/csrc/dac_res.cu",
            replaces.format(327, "res_unit_fused", 376),
            [check_res(torch, 1, 1024, 192, (9,))]),
    }


def check_decode(torch, fused, unfused, segment):
    """The full-width fused decoder on the card against the same decoder on
    the CPU (plain versions) at 200 latent frames, where B8, B7 and B6 are
    all eligible: max abs <= 5e-3, the fp32 decode-parity bound of the
    repo's DAC tests.  Then the fused decode against the unfused one on the
    card, at one segment: max abs < 5e-2, the JAX package's fused-decode
    bound."""
    import numpy as np

    from jatsr_torch.models.dac import DAC
    from jatsr_torch.models.dac.model import init_decoder_params

    cfg = fused.cfg
    z = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        (1, 200, cfg.latent_dim)).astype(np.float32))
    cpu = DAC(init_decoder_params(cfg, SEED), cfg, fused_res_units=True,
              device="cpu")
    ref = cpu.decode(z)
    out = fused.decode(z.cuda()).cpu()
    err = (out - ref).abs().max().item()
    log(f"[reference decode] fused decoder, card vs CPU plain path, full "
        f"width, 200 frames: max abs {err:.3e}, max |ref| "
        f"{ref.abs().max().item():.3e}")
    if not bool(torch.isfinite(out).all()) or err > 5e-3:
        raise AssertionError(f"fused decode: card vs CPU max abs {err} > 5e-3")
    a, b = fused.decode(segment), unfused.decode(segment)
    err2 = (a - b).abs().max().item()
    log(f"[reference decode] fused vs unfused decode on the card, one "
        f"{segment.shape[1]}-frame segment: max abs {err2:.3e}, max |unfused| "
        f"{b.abs().max().item():.3e}")
    if err2 >= 5e-2:
        raise AssertionError(f"fused vs unfused decode: max abs {err2}")


# Kernel-name substrings by kind, for the profile's summary (first match;
# the port's kernels, all in anonymous namespaces, are matched first: a
# template's name starts with its return type, "void (anonymous ...").
PROFILE_GROUPS = (
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "Kernel2")),
    ("FFT", ("fft", "FFT", "regular_fft", "vector_fft")),
    ("convolution (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "distribution")),
)


def profile_phase(torch, name, fn):
    """Trace ``fn()`` with torch.profiler: the card's busy share over the
    phase's wall time, and device time and launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # union of kernel intervals, us
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    log(f"[profile {name}] wall {wall / 1e3:.1f} ms (traced), device busy "
        f"{busy / 1e3:.1f} ms = {busy / wall:.1%}, {len(kernels)} launches")
    groups = {}
    for kname, (us, n) in by_name.items():
        g = "port kernels" if kname.split("(anonymous namespace)::")[0] in (
            "", "void ") \
            else next((g for g, keys in PROFILE_GROUPS if any(
                k in kname for k in keys)), "other")
        gu, gn = groups.get(g, (0.0, 0))
        groups[g] = (gu + us, gn + n)
    log(f"[profile {name}] by kind: " + "; ".join(
        f"{g} {us / 1e3:.2f} ms ({us / busy:.1%}, {n}x)"
        for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        short = kname.split("(anonymous namespace)::")
        if short[0] in ("", "void "):  # each launch of each port kernel
            log(f"[profile {name}] port kernel {short[1].split('(')[0]}: "
                f"{us / 1e3:.3f} ms, {n}x, {us / n:.2f} us each")
    for kname, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:24]:
        log(f"[profile {name}] {us / 1e3:8.2f} ms {us / busy:6.1%} "
            f"{n:6d}x  {kname[:100]}")


def make_server(torch, model, codec, lr, snake="float32"):
    """``(sample, decode, serve)`` for one DiT path: the pipeline's
    sampler over the whole latent, the segmented decode (the DAC kernels'
    snake in ``snake``), and one timed serving pass ``-> (latent, pieces,
    sampler s, end-to-end s)``."""
    import numpy as np

    from jatsr_torch.configs import SamplerConfig
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.ops import dac_kernels as dk
    from jatsr_torch.train.step import Normalizer

    C = model.cfg.input_channels
    norm = Normalizer(np.zeros(C), np.ones(C), np.zeros(C), np.ones(C))
    pipe = InferencePipeline(model, norm, codec,
                             SamplerConfig(num_steps=STEPS,
                                           cfg_scale=CFG_SCALE))

    def sample():
        return pipe.super_resolve_latent_device(lr, SEED, STEPS, CFG_SCALE,
                                                max_batch=3)

    def decode(latent):
        dk.set_snake_compute_dtype(snake)
        try:
            return pipe.decode_latent_pieces(latent, SEGMENT_FRAMES,
                                             CTX_FRAMES)
        finally:
            dk.set_snake_compute_dtype("float32")

    def serve():
        t0 = time.perf_counter()
        latent = sample()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pieces = decode(latent)
        torch.cuda.synchronize()
        return latent, pieces, t1 - t0, time.perf_counter() - t0

    return sample, decode, serve


def counted_pass(torch, name, serve, counters, expected, C):
    """One serving pass with every launch count set to 0 just before it
    and read just after; checks the counts, the latent and the waveform."""
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    latent, pieces, _, _ = serve()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[serve {name}] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{name}: launch counts {launches} != {expected}")
    wav = torch.cat(pieces)
    if latent.shape != (LATENT_FRAMES, C) or not bool(
            torch.isfinite(latent).all()):
        raise AssertionError(f"latent {tuple(latent.shape)} not finite/shaped")
    if wav.shape != (LATENT_FRAMES * 512,):
        raise AssertionError(f"wav length {wav.shape[0]} != {LATENT_FRAMES * 512}")
    if not bool(torch.isfinite(wav).all()) or wav.abs().max().item() > 1.0:
        raise AssertionError("wav not finite or outside [-1, 1]")
    log(f"[serve {name}] {LATENT_FRAMES * 512 / 44100:.2f} s of audio, "
        f"{len(pieces)} decode segments, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, latent


def short_pass(torch, name, model, lr, counters, expected):
    """One sampler call of ``model`` on the first 16 s chunk of ``lr``
    (SHORT_STEPS Euler steps, CFG), every launch count set to 0 just before
    it and read just after; checks the counts and a finite latent of the
    chunk's shape.  No decode."""
    import numpy as np

    from jatsr_torch.configs import SamplerConfig
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.train.step import Normalizer

    C = model.cfg.input_channels
    norm = Normalizer(np.zeros(C), np.ones(C), np.zeros(C), np.ones(C))
    pipe = InferencePipeline(model, norm, None,
                             SamplerConfig(num_steps=SHORT_STEPS,
                                           cfg_scale=CFG_SCALE))
    chunk = lr[:SHORT_FRAMES]
    pipe.super_resolve_latent_device(chunk, SEED, SHORT_STEPS, CFG_SCALE)
    torch.cuda.synchronize()  # the warm-up
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    latent = pipe.super_resolve_latent_device(chunk, SEED, SHORT_STEPS,
                                              CFG_SCALE)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[serve {name}] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{name}: launch counts {launches} != {expected}")
    if latent.shape != (SHORT_FRAMES, C) or not bool(
            torch.isfinite(latent).all()):
        raise AssertionError(f"{name}: latent {tuple(latent.shape)} not "
                             f"finite/shaped")
    log(f"[serve {name}] one {SHORT_FRAMES}-frame chunk, {SHORT_STEPS} steps "
        f"CFG {CFG_SCALE}: sampler {sec * 1e3:.1f} ms (one counted call)")
    return launches


def timed_passes(servers, card):
    """``TIMED_RUNS`` serving passes of each path, in turns (A B B A ...),
    so that a drift of the host or the card touches both alike.  A server
    returns ``(..., sampler s, end-to-end s)``; the audio path's sampler
    time is None (its one entry point runs encode, sampler and decode)."""
    names = list(servers)
    times = {n: [] for n in names}
    for r in range(TIMED_RUNS):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(servers[n]()[2:])
    audio_sec = LATENT_FRAMES * 512 / 44100
    for n, ts in times.items():
        t_e2e = sorted(t for _, t in ts)[len(ts) // 2]
        if ts[0][0] is None:
            log(f"[serve {n}] {TIMED_RUNS} runs, audio in, audio out ms "
                f"{[round(t * 1e3, 1) for _, t in ts]}")
            log(f"[serve {n}] median: audio in, audio out "
                f"{AUDIO_SEC / t_e2e:.2f} audio-sec/s ({t_e2e * 1e3:.1f} "
                f"ms); {AUDIO_SEC:.1f} s of {AUDIO_SR} Hz audio, {STEPS} "
                f"steps CFG {CFG_SCALE}, batch 6; {card}")
            continue
        t_sample = sorted(t for t, _ in ts)[len(ts) // 2]
        log(f"[serve {n}] {TIMED_RUNS} runs, sampler ms "
            f"{[round(t * 1e3, 1) for t, _ in ts]}, end-to-end ms "
            f"{[round(t * 1e3, 1) for _, t in ts]}")
        log(f"[serve {n}] median: sampler {audio_sec / t_sample:.2f} "
            f"audio-sec/s ({t_sample * 1e3:.1f} ms), end to end "
            f"{audio_sec / t_e2e:.2f} audio-sec/s ({t_e2e * 1e3:.1f} ms); "
            f"{STEPS} steps CFG {CFG_SCALE}, batch 6")


def check_reference(torch, name, model, cpu_model, frames):
    """The full-width DiT on the card (kernels) against the same DiT on the
    CPU (plain versions) at [2, frames, C]: relative L2 < 5e-2."""
    import numpy as np

    C = model.cfg.input_channels
    rng = np.random.default_rng(SEED + 1)
    x_t = torch.from_numpy(rng.standard_normal((2, frames, C),
                                               dtype=np.float32))
    x_c = torch.from_numpy(rng.standard_normal((2, frames, C),
                                               dtype=np.float32))
    t = torch.tensor([0.25, 0.75])
    ref = cpu_model(x_t, t, x_c)
    out = model(x_t.cuda(), t.cuda(), x_c.cuda()).cpu()
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"[reference {name}] card vs CPU plain path, full width, "
        f"[2, {frames}, {C}]: rel L2 {rel:.3e}, max abs "
        f"{(out - ref).abs().max().item():.3e}, mean |ref| "
        f"{ref.abs().mean().item():.3e}")
    if not bool(torch.isfinite(out).all()) or rel > 5e-2:
        raise AssertionError(f"{name}: card DiT disagrees with the plain "
                             f"path: rel L2 {rel} > 5e-2")


# ---- audio in, audio out ----------------------------------------------------
AUDIO_SR = 16000
AUDIO_SAMPLES = 704_000       # 44.0 s of mono 16 kHz audio: 3790 frames
AUDIO_SEC = AUDIO_SAMPLES / AUDIO_SR
# Heun on the card against the CPU: one forward's card-vs-CPU bound is 5e-2
# (check_reference; measured ~2e-2, int8 code flips where the fp32 sums run
# in another order); 15 forwards feed those flips back through the ODE, and
# CFG 3.0 extrapolates the conditional-unconditional difference x3: twice
# the one-forward bound.
REL_HEUN = 1e-1


def lr_audio():
    """The phase's input, from the seed: two tones and noise, fp32."""
    import numpy as np

    t = np.arange(AUDIO_SAMPLES) / AUDIO_SR
    noise = np.random.default_rng(SEED + 3).standard_normal(AUDIO_SAMPLES)
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.15 * np.sin(2 * np.pi * 3000 * t) + 0.05 * noise).astype(
        np.float32)


def audio_pipeline(model, codec, chunk_noise="per_chunk"):
    import numpy as np

    from jatsr_torch.configs import SamplerConfig
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.train.step import Normalizer

    C = model.cfg.input_channels
    norm = Normalizer(np.zeros(C), np.ones(C), np.zeros(C), np.ones(C))
    return InferencePipeline(model, norm, codec, SamplerConfig(
        num_steps=STEPS, cfg_scale=CFG_SCALE, chunk_noise=chunk_noise))


def audio_phase(torch, model, codec, counters, expected, card):
    """The main path's DiT and the fused codec behind
    ``super_resolve_audio``: 44.0 s of 16 kHz audio, resampled to 44.1 kHz,
    encoded (3790 frames), sampled and decoded interleaved.  A warm-up
    pass, then one with every launch count set to 0 just before it and
    read just after (the main path's counts); the waveform; the
    interleaved path bit-equal to the two-phase one under
    ``chunk_noise="batch"``.  Returns ``(launches, serve)``."""
    import numpy as np

    audio = lr_audio()
    pipe = audio_pipeline(model, codec)

    def serve():
        t0 = time.perf_counter()
        wav = pipe.super_resolve_audio(audio, AUDIO_SR, SEED, STEPS,
                                       CFG_SCALE, max_batch=3)
        return wav, None, None, time.perf_counter() - t0

    serve()  # warm-up: cuDNN's choice at the encoder's shapes
    enc = []
    for _ in range(3):
        t0 = time.perf_counter()
        lat = pipe.encode_lr_audio(audio, AUDIO_SR)
        enc.append(time.perf_counter() - t0)
    log(f"[audio] resample 16 kHz -> 44.1 kHz and encode {AUDIO_SEC:.1f} s "
        f"(3 runs): ms {[round(t * 1e3, 1) for t in enc]}; latent "
        f"{lat.shape}")
    if lat.shape != (LATENT_FRAMES, model.cfg.input_channels):
        raise AssertionError(f"audio latent {lat.shape}")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    wav = serve()[0]
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[audio] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"audio: launch counts {launches} != {expected}")
    n_out = LATENT_FRAMES * codec.cfg.hop_length
    if wav.shape != (n_out,) or not np.isfinite(wav).all() \
            or np.abs(wav).max() > 1.0:
        raise AssertionError(f"audio: wav {wav.shape} not finite, of "
                             f"{n_out} samples in [-1, 1]")
    log(f"[audio] {AUDIO_SEC:.1f} s of {AUDIO_SR} Hz audio in, "
        f"{wav.shape[0]} samples at 44.1 kHz out, max |wav| "
        f"{np.abs(wav).max():.3f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    evaluate_line(audio, wav)
    batch = audio_pipeline(model, codec, chunk_noise="batch")
    lat = batch.encode_lr_audio(audio, AUDIO_SR)
    a = batch.super_resolve_latent_to_audio(lat, SEED, STEPS, CFG_SCALE,
                                            max_batch=3)
    b = batch.decode_latent(batch.super_resolve_latent_device(
        lat, SEED, STEPS, CFG_SCALE, max_batch=3))
    log(f"[audio] interleaved vs two-phase under chunk_noise='batch': "
        f"bit-equal {np.array_equal(a, b)}, max abs "
        f"{np.abs(a - b).max():.3e}")
    if not np.array_equal(a, b):
        raise AssertionError("interleaved sample/decode != two-phase")
    return launches, serve


def evaluate_line(audio, wav):
    """``python -m jatsr_torch.cli.evaluate`` on the audio phase's output
    against its input (resampled to 44.1 kHz on the host): the JAX CLI's
    report (LSD, mel L1/L2, multi-scale, grade) of a random DiT's output;
    the numbers must be finite."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from jatsr_torch.cli import evaluate
    from jatsr_torch.ops.resample import resample
    from jatsr_torch.utils.audio_io import save_wav

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_evaluate_"))
    try:
        gt = resample(torch.from_numpy(audio)[None], AUDIO_SR, 44100)[0]
        save_wav(tmp / "gt.wav", gt.numpy(), 44100)
        save_wav(tmp / "pred.wav", wav, 44100)
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            got = evaluate.main(["--pred", str(tmp / "pred.wav"), "--gt",
                                 str(tmp / "gt.wav")])
        log(f"[evaluate] the audio phase's output against its input "
            f"({time.perf_counter() - t0:.1f} s on the host): "
            + " | ".join(x.strip() for x in text.getvalue().splitlines()))
        if not all(np.isfinite(v) for v in got.values()):
            raise AssertionError(f"evaluate: {got}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_audio_references(torch, codec):
    """The production codec's encoder and RVQ on the card against the CPU
    (plain path) on 4096 samples: z_e within 3e-4 of its scale and at most
    2 % of the codes differing, the bounds of ``tests/test_dac.py`` against
    the torch mirror (fp32 sums in another order flip near-tied argmaxes);
    no decode kernel in the encoder.  Then resampling 16 kHz -> 44.1 kHz,
    1 s: within 2e-6 (one fp32 conv; the taps summed in another order)."""
    import numpy as np

    from jatsr_torch.models.dac import DAC
    from jatsr_torch.ops import dac_kernels as dk
    from jatsr_torch.ops.resample import resample

    rng = np.random.default_rng(SEED + 4)
    t = np.arange(4096) / 44100.0
    x = torch.from_numpy((0.3 * np.sin(2 * np.pi * 440 * t)
                          + 0.05 * rng.standard_normal(4096)).astype(
        np.float32)).reshape(1, -1, 1)
    cpu = DAC.random_init(SEED, codec.cfg, device="cpu")
    n0 = dk.res_unit_fused.launches + dk.res_stage_fused.launches
    z_e = codec.encode_continuous(x.cuda()).cpu()
    _, codes = codec.encode(x.cuda())
    if dk.res_unit_fused.launches + dk.res_stage_fused.launches != n0:
        raise AssertionError("the encoder launched a decode kernel")
    want_e = cpu.encode_continuous(x)
    _, want_codes = cpu.encode(x)
    err = (z_e - want_e).abs().max().item()
    scale = want_e.abs().max().item()
    flips = (codes.cpu() != want_codes).float().mean().item()
    log(f"[reference audio] encoder, card vs CPU plain path, production "
        f"codec, 4096 samples: z_e max abs {err:.3e} of max {scale:.3e} "
        f"(bound 3e-4 x max); codes differing {flips:.4%} of "
        f"{codes.numel()} (bound 2 %)")
    if err > 3e-4 * scale or flips > 0.02:
        raise AssertionError(f"encoder: card vs CPU z_e {err}, codes {flips}")
    y = torch.from_numpy(lr_audio()[:AUDIO_SR])[None]
    got = resample(y.cuda(), AUDIO_SR, 44100).cpu()
    want = resample(y, AUDIO_SR, 44100)
    err = (got - want).abs().max().item()
    log(f"[reference audio] resample 16 kHz -> 44.1 kHz, 1 s, card vs CPU: "
        f"{tuple(got.shape)}, max abs {err:.3e} (bound 2e-6)")
    if got.shape != (1, 44100) or err > 2e-6:
        raise AssertionError(f"resample: card vs CPU {err}")


def check_heun(torch, model, cpu_model, frames=100):
    """One Heun call of the main path's sampler (8 steps, CFG 3.0,
    doubled) on one [1, frames, C] chunk, on the card and on the CPU (plain
    path), each counting its forwards: 2 x 8 - 1, the last interval's
    Euler step taking one.  Relative L2 < ``REL_HEUN``."""
    import numpy as np

    from jatsr_torch.configs import SamplerConfig
    from jatsr_torch.models.dit import adaln_tables
    from jatsr_torch.sampling import FlowSampler

    C = model.cfg.input_channels
    rng = np.random.default_rng(SEED + 5)
    cond, z0 = (torch.from_numpy(rng.standard_normal((1, frames, C),
                                                     dtype=np.float32))
                for _ in range(2))
    outs, forwards = [], []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        calls = [0]

        def fn(z, t, c, mod=None, m=m, calls=calls):
            calls[0] += 1
            return m(z, t, c, adaln_mod=mod)

        sampler = FlowSampler(fn, SamplerConfig(num_steps=STEPS,
                                                solver="heun"),
                              adaln_fn=lambda tv, m=m: adaln_tables(m, tv),
                              device=dev)
        outs.append(sampler(cond.to(dev), STEPS, CFG_SCALE,
                            z0=z0.to(dev)).cpu())
        forwards.append(calls[0])
    out, ref = outs
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"[reference heun] main path's DiT, Heun {STEPS} steps CFG "
        f"{CFG_SCALE} on [1, {frames}, {C}]: forwards card {forwards[0]}, "
        f"CPU {forwards[1]} (expected {2 * STEPS - 1}); card vs CPU rel L2 "
        f"{rel:.3e}, max abs {(out - ref).abs().max().item():.3e}")
    if forwards != [2 * STEPS - 1] * 2 or not bool(
            torch.isfinite(out).all()) or rel > REL_HEUN:
        raise AssertionError(f"heun: forwards {forwards}, rel L2 {rel}")


# ---- the training path: B10 and the v3mod2 train step ----------------------
# B10's backward against its plain version: max abs <= 1e-2 x max |plain|
# per gradient.  Its outputs are bf16 (half an ulp is 2e-3 of a value near
# the top of the range) and ds rounds to bf16 before the dk and dq products,
# so where the kernel's fp32 sums run in another order some ds move by one
# ulp; measured 4.3e-3 x max at this shape.
REL_ATTN_BWD = 1e-2


def check_attention_train(torch):
    """B10 forward and backward against their plain versions at the v3
    training shapes (q [28, 345, 1280], k/v [28, 345, 256]) with dropout
    0.1 and a negative seed, two runs of each bit-equal; timed beside SDPA
    (kv heads repeated outside, dropout 0.1) forward and backward."""
    import torch.nn.functional as F

    from jatsr_torch.ops import attention_train as at

    hq, hkv, D, rate, seed = 20, 4, 64, 0.1, -123456789
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn((TRAIN_B, TRAIN_N, w * D), generator=gen,
                               device="cuda").bfloat16()
                   for w in (hq, hkv, hkv, hq))
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    o2, stats2 = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(stats, stats2)):
        raise AssertionError("B10 forward: two runs differ")
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    err_f = (o.float() - want.float()).abs().max().item()
    got = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    again = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    ref = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    err_b, rel_b = 0.0, 0.0
    for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
        if not torch.equal(a, a2):
            raise AssertionError(f"B10 backward {name}: two runs differ")
        e = (a.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if not bool(torch.isfinite(a).all()) or e > REL_ATTN_BWD * scale:
            raise AssertionError(f"B10 backward {name}: max abs {e} > "
                                 f"{REL_ATTN_BWD} x max |plain| {scale}")
        err_b, rel_b = max(err_b, e), max(rel_b, e / scale)
    del got, again, ref, want

    def heads(x, h):  # [B, N, h*D] -> [B, hq, N, D], kv heads repeated
        x = x.reshape(TRAIN_B, TRAIN_N, h, D).transpose(1, 2)
        return x.repeat_interleave(hq // h, 1).contiguous()

    q4, k4, v4, do4 = heads(q, hq), heads(k, hkv), heads(v, hkv), heads(do, hq)
    fwd = timings(
        lambda q, k, v, *_: at.attention_train_fwd(q, k, v, seed, hq, hkv,
                                                   rate),
        lambda q, k, v, *_: at.attention_train_fwd_plain(q, k, v, seed, hq,
                                                         hkv, rate),
        lambda q, k, v, q4, k4, v4: F.scaled_dot_product_attention(
            q4, k4, v4, dropout_p=rate),
        (q, k, v, q4, k4, v4), big=(0, 1, 2, 3, 4, 5), reps=50,
        plain_reps=3)
    q4g, k4g, v4g = (x.clone().requires_grad_() for x in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, dropout_p=rate)
    bwd = timings(
        lambda q, k, v, o, do, *_: at.attention_train_bwd(
            q, k, v, o, do, seed, hq, hkv, rate, stats),
        lambda q, k, v, o, do, *_: at.attention_train_bwd_plain(
            q, k, v, o, do, seed, hq, hkv, rate),
        lambda *a: torch.autograd.grad(out4, (q4g, k4g, v4g), a[5],
                                       retain_graph=True),
        (q, k, v, o, do, do4), big=(0, 1, 2, 3, 4), reps=30, plain_reps=3)
    del out4, q4g, k4g, v4g
    pairs = TRAIN_B * hq * TRAIN_N * TRAIN_N * D
    b_f = bound(nbytes_of(q, k, v, o, stats), 4 * pairs, PEAK_BF16)
    b_b = bound(nbytes_of(q, k, v, o, do, stats) + nbytes_of(q, k, v),
                10 * pairs, PEAK_BF16)
    replaces = ("ops/attention_train.py:340 (JAX package, "
                "gqa_attention_train; {} pallas_call :{})")
    shape = [TRAIN_B, TRAIN_N, hq, hkv, D]
    fwd32, bwd32 = check_attention_train_at(torch, 4, 2, 32, SEED + 33,
                                            timed=False)
    fwd256, bwd256 = check_attention_train_at(torch, 20, 4, 256, SEED + 36,
                                              timed=True)
    return {
        "attention_train_fwd": {
            "name": "attention_train_fwd", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/attention_train.cu",
            "replaces": replaces.format("_fwd_call :258,", 266),
            "max_abs_err": err_f, **fwd, "bound_ms": b_f[0],
            "bound_by": b_f[1], "shape": shape, "dropout": rate,
            "head_dim_32": fwd32, "head_dim_256": fwd256},
        "attention_train_bwd": {
            "name": "attention_train_bwd", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/attention_train.cu",
            "replaces": replaces.format("_attn_train_bwd :300,", 312),
            "max_abs_err": err_b, "max_rel_to_max": rel_b, **bwd,
            "bound_ms": b_b[0], "bound_by": b_b[1], "shape": shape,
            "dropout": rate, "head_dim_32": bwd32, "head_dim_256": bwd256}}


def check_attention_train_at(torch, hq, hkv, D, seed_, timed):
    """B10 forward and backward at hq/hkv heads and head dim D (32: tiny's
    4/2; 256: v3's 20/4 past 128, csrc/attention_wide.cu), batch 4, N 345,
    dropout 0.1, against their plain versions (the tolerances above), two
    runs of each bit-equal; with ``timed`` the ms of each (50 and 20 calls
    on one input set)."""
    from jatsr_torch.ops import attention_train as at

    rate, seed = 0.1, -123456789
    gen = torch.Generator(device="cuda").manual_seed(seed_)
    q, k, v, do = (torch.randn((4, TRAIN_N, w * D), generator=gen,
                               device="cuda").bfloat16()
                   for w in (hq, hkv, hkv, hq))
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    o2, stats2 = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(stats, stats2)):
        raise AssertionError(f"B10 forward at D {D}: two runs differ")
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2, rtol=2e-2)
    got = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    again = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    ref = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    err_b = 0.0
    for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
        e = (a.float() - r.float()).abs().max().item()
        if not torch.equal(a, a2) or e > REL_ATTN_BWD * r.float().abs().max(
                ).item():
            raise AssertionError(f"B10 backward {name} at D {D}: max abs {e}")
        err_b = max(err_b, e)
    shape = [4, TRAIN_N, hq, hkv, D]
    fwd = {"shape": shape,
           "max_abs_err": (o.float() - want.float()).abs().max().item()}
    bwd = {"shape": shape, "max_abs_err": err_b}
    if timed:
        fwd["ms"] = time_ms(lambda *_: at.attention_train_fwd(
            q, k, v, seed, hq, hkv, rate), [()], 50)
        bwd["ms"] = time_ms(lambda *_: at.attention_train_bwd(
            q, k, v, o, do, seed, hq, hkv, rate, stats), [()], 20)
    return fwd, bwd


# B10's fp32 mode (csrc/attention_f32.cu's train mode, the backward in
# csrc/attention_f32_bwd.cu) against its plain version: every product in
# fp32 on both sides (TF32 off), the kernels' sums in another order; each
# output and gradient within 1e-4 x max |plain| (a sum of n fp32 terms in
# another order moves by at most ~n u of their magnitudes' sum, u = 2^-24:
# 5e-5 of it at n = 768; the measured errors are far below).
REL_F32_TRAIN = 1e-4


def check_f32_train_pair(torch, B, N, hq, hkv, D, seed_, rate, seed):
    """B10's fp32 forward and backward at one shape: each against its plain
    version (``REL_F32_TRAIN``), two runs of each bit-equal.  Returns the
    inputs, the forward's output and stats and the two max abs errors."""
    from jatsr_torch.ops import attention_train as at

    gen = torch.Generator(device="cuda").manual_seed(seed_)
    q, k, v, do = (torch.randn((B, N, w * D), generator=gen, device="cuda")
                   for w in (hq, hkv, hkv, hq))
    o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    o2, stats2 = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
    want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    what = f"B10 fp32 at [{B}, {N}, {hq}/{hkv}, {D}]"
    if o.dtype != torch.float32 or not (torch.equal(o, o2)
                                        and torch.equal(stats, stats2)):
        raise AssertionError(f"{what} forward: not fp32, or two runs differ")
    err_f = (o - want).abs().max().item()
    if not bool(torch.isfinite(o).all()) or \
            err_f > REL_F32_TRAIN * want.abs().max().item():
        raise AssertionError(f"{what} forward: max abs {err_f}")
    got = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    again = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate, stats)
    ref = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq, hkv, rate)
    torch.cuda.synchronize()
    err_b = 0.0
    for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, ref):
        e = (a - r).abs().max().item()
        if a.dtype != torch.float32 or not torch.equal(a, a2) \
                or not bool(torch.isfinite(a).all()) \
                or e > REL_F32_TRAIN * r.abs().max().item():
            raise AssertionError(f"{what} backward {name}: max abs {e}, or "
                                 f"two runs differ")
        err_b = max(err_b, e)
    return (q, k, v, do, o, stats), err_f, err_b


def check_attention_train_fp32(torch, checks):
    """B10's fp32 mode at the v3mod2 step's shapes (q [28, 345, 1280], k/v
    [28, 345, 256] fp32, dropout 0.1, a negative seed) against its plain
    versions, two runs of each bit-equal, timed beside fp32 SDPA (kv heads
    repeated, dropout 0.1) forward and autograd backward; then at D 32 (4/2
    heads), 128 and 256 (20/4) at batch 4, N 345, and at N 768 (D 64), each
    checked the same way and timed.  The kernel lines carry the bf16 mode's
    ms of this run beside."""
    import torch.nn.functional as F

    from jatsr_torch.ops import attention_train as at

    hq, hkv, D, rate, seed = 20, 4, 64, 0.1, -123456789
    (q, k, v, do, o, stats), err_f, err_b = check_f32_train_pair(
        torch, TRAIN_B, TRAIN_N, hq, hkv, D, SEED + 40, rate, seed)

    def heads(x, h):  # [B, N, h*D] -> [B, hq, N, D], kv heads repeated
        x = x.reshape(TRAIN_B, TRAIN_N, h, D).transpose(1, 2)
        return x.repeat_interleave(hq // h, 1).contiguous()

    q4, k4, v4, do4 = heads(q, hq), heads(k, hkv), heads(v, hkv), heads(do, hq)
    fwd = timings(
        lambda q, k, v, *_: at.attention_train_fwd(q, k, v, seed, hq, hkv,
                                                   rate),
        lambda q, k, v, *_: at.attention_train_fwd_plain(q, k, v, seed, hq,
                                                         hkv, rate),
        lambda q, k, v, q4, k4, v4: F.scaled_dot_product_attention(
            q4, k4, v4, dropout_p=rate),
        (q, k, v, q4, k4, v4), big=(0, 1, 2, 3, 4, 5), reps=20,
        plain_reps=3)
    q4g, k4g, v4g = (x.clone().requires_grad_() for x in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, dropout_p=rate)
    bwd = timings(
        lambda q, k, v, o, do, *_: at.attention_train_bwd(
            q, k, v, o, do, seed, hq, hkv, rate, stats),
        lambda q, k, v, o, do, *_: at.attention_train_bwd_plain(
            q, k, v, o, do, seed, hq, hkv, rate),
        lambda *a: torch.autograd.grad(out4, (q4g, k4g, v4g), a[5],
                                       retain_graph=True),
        (q, k, v, o, do, do4), big=(0, 1, 2, 3, 4), reps=10, plain_reps=3)
    del out4, q4g, k4g, v4g, q4, k4, v4, do4
    pairs = TRAIN_B * hq * TRAIN_N * TRAIN_N * D
    b_f = bound(nbytes_of(q, k, v, o, stats), 4 * pairs, PEAK_FP32)
    b_b = bound(nbytes_of(q, k, v, o, do, stats) + nbytes_of(q, k, v),
                10 * pairs, PEAK_FP32)
    del q, k, v, do, o, stats
    extra = {"fwd": {}, "bwd": {}}
    for name, B_, N_, hq_, hkv_, D_ in (
            ("head_dim_32", 4, TRAIN_N, 4, 2, 32),
            ("head_dim_128", 4, TRAIN_N, 20, 4, 128),
            ("head_dim_256", 4, TRAIN_N, 20, 4, 256),
            ("n_768", 4, 768, 20, 4, 64)):
        (q, k, v, do, o, stats), ef, eb = check_f32_train_pair(
            torch, B_, N_, hq_, hkv_, D_, SEED + 41, rate, seed)
        shape = [B_, N_, hq_, hkv_, D_]
        extra["fwd"][name] = {"shape": shape, "max_abs_err": ef,
                              "ms": time_ms(lambda *_: at.attention_train_fwd(
                                  q, k, v, seed, hq_, hkv_, rate), [()], 20)}
        extra["bwd"][name] = {"shape": shape, "max_abs_err": eb,
                              "ms": time_ms(lambda *_: at.attention_train_bwd(
                                  q, k, v, o, do, seed, hq_, hkv_, rate,
                                  stats), [()], 10)}
        del q, k, v, do, o, stats
    torch.cuda.empty_cache()
    shape = [TRAIN_B, TRAIN_N, hq, hkv, D]
    out = {}
    for way, f, e, b_, src in (
            ("fwd", fwd, err_f, b_f, "jatsr_torch/ops/csrc/attention_f32.cu"),
            ("bwd", bwd, err_b, b_b,
             "jatsr_torch/ops/csrc/attention_f32_bwd.cu")):
        line = fp32_line(checks[f"attention_train_{way}"], {
            "max_abs_err": e, **f, "bound_ms": b_[0], "bound_by": b_[1],
            "shape": shape, "dropout": rate, **extra[way]}, src)
        out[line["name"]] = line
    return out


def check_tiny_train_step(torch):
    """One train step of the tiny preset (head dim 32: B10 at D = 32, twice
    a block forward and once backward) on the card against the CPU on the
    same weights, batch [4, 130, 1024] and draws: loss rtol 1e-2, grad norm
    2e-2, updated parameters within 2 lr and 2 % of lr on average (the
    card test's bounds)."""
    import numpy as np

    from jatsr_torch.configs import LossConfig, TrainConfig, get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    cfg = get_preset("tiny").model
    C = cfg.input_channels
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, cfg_dropout_prob=0.2)
    dense = random_dense_params(cfg, SEED + 34)
    rng = np.random.default_rng(SEED + 35)
    hr, lr = (torch.from_numpy(rng.standard_normal((4, 130, C),
                                                   dtype=np.float32))
              for _ in range(2))
    draws = {"noise": rng.standard_normal((4, 130, C), dtype=np.float32),
             "u": rng.random(4, dtype=np.float32),
             "cond_noise": rng.standard_normal((4, 130, C), dtype=np.float32),
             "cfg_u": rng.random((4, 1, 1), dtype=np.float32),
             "layer_seeds": [3, 4]}
    ones = np.ones(C, np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(DenseDiT(cfg, dense, device=dev), tcfg,
                                   100, (hr, lr), device=dev)
        step = make_train_step(LossConfig(), tcfg,
                               Normalizer(0 * ones, ones, 0 * ones, ones,
                                          device=dev))
        n0 = (at.attention_train_fwd.launches,
              at.attention_train_bwd.launches)
        state, m = step(state, hr, lr, draws=draws)
        n = (at.attention_train_fwd.launches - n0[0],
             at.attention_train_bwd.launches - n0[1])
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.params], n)
    (m_c, p_c, n_c), (m_g, p_g, n_g) = out["cpu"], out["cuda"]
    p_max = max((a - b).abs().max().item() for a, b in zip(p_g, p_c))
    p_mean = max((a - b).abs().mean().item() for a, b in zip(p_g, p_c))
    log(f"[train tiny] card vs CPU: loss {m_g['loss']:.6f} vs "
        f"{m_c['loss']:.6f}, grad_norm {m_g['grad_norm']:.6f} vs "
        f"{m_c['grad_norm']:.6f}; params max {p_max / tcfg.lr:.3f} lr, worst "
        f"leaf mean {p_mean / tcfg.lr:.5f} lr; B10 launches {n_g}")
    if (n_c != (0, 0) or n_g != (2 * cfg.depth, cfg.depth)
            or abs(m_g["loss"] - m_c["loss"]) > 1e-2 * abs(m_c["loss"])
            or abs(m_g["grad_norm"] - m_c["grad_norm"])
            > 2e-2 * m_c["grad_norm"]
            or p_max > 2 * tcfg.lr * 1.01 or p_mean > 0.02 * tcfg.lr):
        raise AssertionError("the tiny train step on the card disagrees "
                             "with the CPU's")


def train_batch(torch, cfg):
    """The seeded hr/lr latents [28, 1378, 1024] on the card and seeded
    normalization stats."""
    import numpy as np

    C = cfg.input_channels
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    hr, lr = (torch.randn((TRAIN_B, TRAIN_FRAMES, C), generator=gen,
                          device="cuda") for _ in range(2))
    rng = np.random.default_rng(SEED + 8)
    stats = (0.1 * rng.standard_normal(C), 0.5 + rng.random(C),
             0.1 * rng.standard_normal(C), 0.5 + rng.random(C))
    return hr, lr, stats


# The training paths: v3mod2 as its preset trains it (bf16 compute, fp32
# parameters), at the fp32 compute dtype (the JAX import tool's model,
# fine-tuned: B10's fp32 mode), with bf16 parameters (bf16 gradients and
# second moment; B10's bf16 mode) and under dynamic int8
# (matmul_precision="int8", int8_impl="fused": B4 at every projection but
# the t-MLP and AdaLN, replayed under remat "full"; the backward's int32
# products are torch._int_mm, as JAX leaves them to XLA).
TRAIN_PATHS = {"train": {}, "train_fp32": {"dtype": "float32"},
               "train_bf16_params": {"param_dtype": "bfloat16"},
               "train_int8": {"matmul_precision": "int8",
                              "int8_impl": "fused"}}
TRAIN_REF_DEPTH = 8   # blocks of the card-vs-CPU steps (the CPU's share)


def train_counters():
    """B10's launch counts: ``launches`` counts both modes, the fp32 lines
    the fp32 one."""
    from jatsr_torch.ops import attention_train as at

    return {"attention_train_fwd": at.attention_train_fwd,
            "attention_train_bwd": at.attention_train_bwd,
            "attention_train_fwd_fp32": Count(at.attention_train_fwd,
                                              "f32_launches"),
            "attention_train_bwd_fp32": Count(at.attention_train_bwd,
                                              "f32_launches")}


def train_phase(torch, dense, profile, tag="train", timed=TRAIN_TIMED):
    """The v3mod2 train step at full width on path ``tag`` of
    ``TRAIN_PATHS``: one counted step (B10 forward 56, backward 28, in the
    fp32 mode at dtype="float32", else in bf16), then ``timed`` steps.
    Returns the counted step's B10 launches."""
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)
    from jatsr_torch.utils.flops import mfu, train_step_flops

    preset = get_preset("v3mod2")
    cfg = dataclasses.replace(preset.model, **TRAIN_PATHS[tag])
    tcfg = dataclasses.replace(preset.train, warmup_steps=TRAIN_WARMUP)
    hr, lr, stats = train_batch(torch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(DenseDiT(cfg, dense, device="cuda"), tcfg,
                               1000, (hr, lr), device="cuda")
    step = make_train_step(preset.loss, tcfg, Normalizer(*stats))
    named = dict(state.model.named_parameters())
    watch = {k: named[k].detach().clone() for k in
             ("blocks.0.attn.q_proj.kernel", "blocks.27.mlp_out.kernel",
              "patch_in.kernel", "final_proj.kernel", "blocks.5.adaln.bias")}
    gib = 2.0 ** 30
    held = sum(t.nbytes for t in (*state.params, *state.opt_state.mu,
                                  *state.opt_state.nu)) / gib
    dtypes = sorted({str(t.dtype) for t in state.params})
    log(f"[{tag}] v3mod2 state on the card: {time.perf_counter() - t0:.1f} s;"
        f" {sum(p.numel() for p in state.params) / 1e6:.1f} M params "
        f"({', '.join(dtypes)}), compute {cfg.dtype}, warmup {TRAIN_WARMUP} "
        f"steps, lr {tcfg.lr}; parameters and moments {held:.2f} GiB (with "
        f"the gradients {held + sum(p.nbytes for p in state.params) / gib:.2f}"
        f" GiB)")
    from jatsr_torch.ops.int8_matmul import int8_matmul_fused

    counters = {**train_counters(), "matmul_fused": int8_matmul_fused}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, m = step(state, hr, lr)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    f32 = cfg.dtype == "float32"
    int8 = cfg.matmul_precision == "int8"
    # Under int8 B4 runs each product of the forward (the patch embed's
    # two, six a block) and the block's six again in remat's replay.
    expected = {"attention_train_fwd": 2 * cfg.depth,
                "attention_train_bwd": cfg.depth,
                "attention_train_fwd_fp32": 2 * cfg.depth if f32 else 0,
                "attention_train_bwd_fp32": cfg.depth if f32 else 0,
                "matmul_fused": 2 + 12 * cfg.depth if int8 else 0}
    log(f"[{tag}] counted step {first * 1e3:.1f} ms, launches {launches} "
        f"(launches count both modes), expected {expected}")
    if launches != expected:
        raise AssertionError(f"{tag} step launches {launches} != {expected}")
    losses, times = [float(m["loss"])], []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, m = step(state, hr, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    moved = {k: (named[k].detach() - w).abs().max().item()
             for k, w in watch.items()}
    log(f"[{tag}] losses {losses}; grad_norm {float(m['grad_norm']):.4f}, "
        f"snr_db {float(m['snr_db']):.3f}; max |param change| {moved}")
    if not all(math.isfinite(x) for x in losses) or min(moved.values()) <= 0 \
            or sorted({str(t.dtype) for t in state.params}) != dtypes:
        raise AssertionError(f"{tag} steps: losses {losses}, moved {moved}")
    med = sorted(times)[len(times) // 2]
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_FRAMES)
    log(f"[{tag}] {timed} timed steps ms "
        f"{[round(t * 1e3, 1) for t in times]}; median {med * 1e3:.1f} ms, "
        f"{TRAIN_B / med:.2f} samples/s, MFU {mfu(flops, med):.4f} "
        f"({flops / 1e12:.2f} TFLOP per step against 989 TFLOP/s bf16), "
        f"peak {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    if profile:
        profile_phase(torch, f"{tag} step", lambda: step(state, hr, lr))
    return launches


def check_loss_stack(torch, loss_cfg):
    """The v3mod2 loss stack on the card against the CPU on one fp32
    prediction [4, 1378, 1024]: values rtol 1e-5, gradients with respect to
    the prediction within 1e-2 x their max.  The log-magnitude gradient at a
    bin is pf / |pf|^2: cuFFT and the CPU's FFT differ by ~1e-7 of the
    typical |pf|, which at the smallest of the 2.8 M bins (|pf| ~1e-3 of
    typical) is ~1e-4 relative and more; measured 1.3e-3 x max."""
    import numpy as np

    from jatsr_torch.losses import total_training_loss

    rng = np.random.default_rng(SEED + 9)
    p, t, c = (torch.from_numpy(rng.standard_normal(
        (REF_B, TRAIN_FRAMES, 1024), dtype=np.float32)) for _ in range(3))
    out = {}
    for dev in ("cpu", "cuda"):
        x = p.detach().to(dev, copy=True).requires_grad_()
        loss, m = total_training_loss(x, t.to(dev), c.to(dev), loss_cfg)
        loss.backward()
        out[dev] = ({k: float(v) for k, v in m.items()}, x.grad.cpu())
    (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
    for k in mc:
        if abs(mg[k] - mc[k]) > 1e-5 * abs(mc[k]):
            raise AssertionError(f"loss {k}: card {mg[k]} vs CPU {mc[k]}")
    err = (gg - gc).abs().max().item() / gc.abs().max().item()
    log(f"[train reference] loss stack card vs CPU: {mg}; grad max abs "
        f"{err:.3e} x max")
    if err > 1e-2:
        raise AssertionError(f"loss gradient: {err} x max")


# The card-vs-CPU train steps' bounds: loss and grad norm relative, the
# first moments (0.1 x the clipped grads) per leaf normalised by their max,
# the updated parameters' largest and worst leaf-mean difference in lr.
# bf16 compute: loss 1e-2, grad norm 2e-2, moments 3e-2 (the JAX package's
# bound for B10 against its einsum path), parameters 2 lr (a first Adam
# step moves each by +-lr, so a gradient whose sign differs in bf16 moves
# it the other way) and 2 % of lr on average.  fp32 compute: every product
# in fp32 on both sides, the sums in another order: loss and grad norm
# 1e-5, moments 1e-4, parameters 0.5 lr and 0.1 % of lr (a gradient error
# of ~1e-6 of its leaf's max moves Adam's g / (|g| + eps) by far less than
# lr, also near g = 0, where eps keeps it continuous; measured on an NVIDIA
# H100 80GB HBM3 at a 700 W limit: loss 0, grad norm 6.5e-8, moments
# 1.9e-6, parameters 0.022 lr at most, 97 % bit-equal).  bf16 parameters:
# the bf16 bounds, but each new parameter is p + u rounded once to bf16,
# which can land on either neighbour where the two updates straddle a
# rounding boundary, so an element may differ by 2 lr plus one bf16 ulp of
# its value (2^-7 |p|; at lr 5e-5 an ulp of a weight near 0.02 is 2.4 lr);
# on average the straddles cost what the fp32 difference of the updates
# does (the chance of a straddle is |du| lr / ulp, its cost one ulp), so
# the 2 % mean bound stands.  Dynamic int8 (``"count"``): the bf16 bounds
# on the loss, the grad norm and the parameters, but a product's
# cotangents land on maxima: the activation's on its row maximum, the
# weight's on its column maximum.  So where the card's forward and the
# CPU's (equal to within bf16 rounding) take a row's maximum at another
# element of a near tie, that row's cotangent moves whole to another
# column upstream (the GELU output's maximum decides which column of
# mlp_in gets a row's gradient, the attention output's which column of v;
# through the attention's backward q and k see it in every column).  The
# moments are held instead by: the int8 kernels' moments nonzero only on
# the kernel's column maxima (on both sides); each leaf's moments past 3e-2
# x max at most twice the rows whose maxima moved (``RowMaxima``: each
# moved row changes a column it left and one it took); each leaf's
# relative L2 difference at most 0.5 (measured on an NVIDIA H100 80GB HBM3
# at a 700 W limit: 0.238 at most, block 7's k_proj, with 1349 moved rows
# over 34 product inputs and 130 elements past the bound at most; a
# cotangent whose sign is wrong reads 2, one off by half 0.5).
# ``check_int8_cotangents`` holds the product's cotangents on the card
# against the CPU's on identical inputs, where nothing moves: the same
# positions, within one bf16 ulp.  The parameters' worst leaf mean is the
# bf16 bound (0.02 lr;
# measured 0.01976, blocks.7.adaln.bias, whose modulation columns get the
# small cotangents of the row maxima, so more elements step on a gradient
# near 0 whose sign the two sides round apart).
TRAIN_REF_BOUNDS = {
    "train": dict(loss=1e-2, grad_norm=2e-2, mu=3e-2, p_max=2.02,
                  p_mean=0.02, ulp=False),
    "train_fp32": dict(loss=1e-5, grad_norm=1e-5, mu=1e-4, p_max=0.5,
                       p_mean=1e-3, ulp=False),
    "train_bf16_params": dict(loss=1e-2, grad_norm=2e-2, mu=3e-2,
                              p_max=2.02, p_mean=0.02, ulp=True),
    "train_int8": dict(loss=1e-2, grad_norm=2e-2, mu=3e-2, count=True,
                       mu_l2=0.5, p_max=2.02, p_mean=0.02, ulp=False)}
# The dynamic int8 kernels of DenseDiT (every projection but the t-MLP,
# the AdaLN and final_proj): their gradients lie on column maxima alone.
INT8_KERNEL = re.compile(
    r"^(patch_in|patch_out|blocks\.\d+\.(attn\.(q|k|v|out)_proj|mlp_in|"
    r"mlp_out))"
    r"\.kernel$")


class RowMaxima:
    """Records, for each distinct ``int8_dot_general`` input of a step (the
    replays of remat compute the same values, and q, k and v share one,
    so each is kept once), the flat positions of every row's maxima of |x|
    (ties kept), on the host."""

    def __init__(self):
        from jatsr_torch.models import dit

        self.dit, self.real, self.calls, self.seen = (
            dit, dit.int8_dot_general, [], set())

    def __enter__(self):
        def record(x, kernel, impl="xla", **kw):
            a = x.detach().abs().reshape(-1, x.shape[-1])
            hit = (a == a.amax(dim=-1, keepdim=True)).flatten()
            pos = hit.nonzero().flatten().cpu()
            key = (a.shape, pos.numel(), int(pos.sum()), float(a.sum()))
            if key not in self.seen:
                self.seen.add(key)
                self.calls.append((a.shape[1], pos))
            return self.real(x, kernel, impl, **kw)

        self.dit.int8_dot_general = record
        return self

    def __exit__(self, *exc):
        self.dit.int8_dot_general = self.real


def moved_rows(torch, calls_a, calls_b):
    """The rows, over the calls of two runs of one step, whose set of
    maxima differs."""
    if len(calls_a) != len(calls_b):
        raise AssertionError(f"int8 products: {len(calls_a)} vs "
                             f"{len(calls_b)} calls")
    n = 0
    for (K, a), (_, b) in zip(calls_a, calls_b):
        pos, count = torch.cat([a, b]).unique(return_counts=True)
        n += (pos[count == 1] // K).unique().numel()
    return n


def check_int8_cotangents(torch):
    """``int8_dot_general(impl="fused")`` forward and backward on the card
    against the CPU on identical inputs at a projection of v3mod2 (x
    [4096, 1280] bf16, a kernel [1280, 1280] bf16 whose column 7 holds a
    tied maximum, an all-zero row of x): the forward bit-equal, the
    cotangents of x and of the kernel nonzero at the same positions, and
    within one bf16 ulp of their largest (2^-8 x max: the fp32 sums run in
    another order, then round to bf16)."""
    from jatsr_torch.ops.quant import int8_dot_general

    gen = torch.Generator().manual_seed(SEED + 42)
    x = torch.randn(4096, 1280, generator=gen).bfloat16()
    x[3] = 0.0
    w = (0.02 * torch.randn(1280, 1280, generator=gen)).bfloat16()
    w[5, 7], w[9, 7] = 0.1, -0.1
    g = torch.randn(4096, 1280, generator=gen).bfloat16()
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, copy=True).requires_grad_()
        wd = w.to(dev, copy=True).requires_grad_()
        y = int8_dot_general(xd, wd, "fused")
        y.backward(g.to(dev))
        out[dev] = [t.cpu() for t in (y.detach(), xd.grad, wd.grad)]
    (yc, xc, wc), (yg, xg, wg) = out["cpu"], out["cuda"]
    errs = {}
    for name, a, b in (("x", xg, xc), ("kernel", wg, wc)):
        same = torch.equal(a != 0, b != 0)
        err = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        errs[name] = (same, err, int((b != 0).sum()))
        if not same or err > 2.0 ** -8:
            raise AssertionError(f"int8_dot_general's cotangent of {name}: "
                                 f"same positions {same}, {err} x max")
    if not torch.equal(yg, yc) or wc[5, 7] != -wc[9, 7] or xc[3].any():
        raise AssertionError("int8_dot_general: the forward, the tie or the "
                             "zero row")
    log(f"[train_int8 reference] int8_dot_general on identical inputs, card "
        f"vs CPU: forward bit-equal; cotangents (same positions, max abs x "
        f"max, nonzero): {errs}")


def shallow(dense, depth):
    """The dense tree of the first ``depth`` blocks (views)."""
    return {**dense, "blocks": _cut_blocks(dense["blocks"], depth)}


def _cut_blocks(tree, depth, copy=False):
    """The first ``depth`` blocks of a stacked tree: views, or with
    ``copy`` numpy copies (so that a saved leaf holds only its blocks)."""
    return {k: _cut_blocks(v, depth, copy) if isinstance(v, dict) else
            (v[:depth].copy() if copy else v[:depth])
            for k, v in tree.items()}


def check_train_reference(torch, dense, tag="train"):
    """One train step of v3mod2 at full width and ``TRAIN_REF_DEPTH``
    blocks on path ``tag`` of ``TRAIN_PATHS``, dropout and drop-path 0, on
    the card against the CPU (plain versions) on the same weights (the
    first blocks), batch [4, 1378, 1024] and draws (a few s of 8 CPU
    cores), within ``TRAIN_REF_BOUNDS[tag]``.

    The loss is the reconstruction (MSE) alone: the perceptual stack's
    log-magnitude gradient is 1 / |rfft(pred)| at each bin, so at random
    weights a few near-zero bins dominate it and a bf16 ulp of the
    prediction moves it by tens of percent; its values and gradients are
    held on identical inputs (``check_loss_stack``, on the bf16 path).  Each
    parameter leaf must move by 0.5 lr somewhere."""
    import numpy as np

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    preset = get_preset("v3mod2")
    cfg = dataclasses.replace(preset.model, dropout=0.0, drop_path_rate=0.0,
                              depth=TRAIN_REF_DEPTH, **TRAIN_PATHS[tag])
    dense = shallow(dense, TRAIN_REF_DEPTH)
    tcfg = dataclasses.replace(preset.train, warmup_steps=0)
    loss_cfg = dataclasses.replace(preset.loss, use_latent_perceptual=False)
    bounds = TRAIN_REF_BOUNDS[tag]
    if tag == "train":
        check_loss_stack(torch, preset.loss)
    if bounds.get("count"):
        check_int8_cotangents(torch)
    hr, lr, stats = train_batch(torch, cfg)
    hr, lr = hr[:REF_B].cpu(), lr[:REF_B].cpu()
    rng = np.random.default_rng(SEED + 10)
    shape = (REF_B, TRAIN_FRAMES, cfg.input_channels)
    draws = {"noise": rng.standard_normal(shape, dtype=np.float32),
             "u": rng.random(REF_B, dtype=np.float32),
             "cond_noise": rng.standard_normal(shape, dtype=np.float32),
             "layer_seeds": [int(s) for s in rng.integers(-2**31, 2**31,
                                                          cfg.depth)]}
    f32 = cfg.dtype == "float32"
    out, maxima = {}, {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        state = create_train_state(DenseDiT(cfg, dense, device=dev), tcfg,
                                   1000, (hr, lr), device=dev)
        if dev == "cpu":
            start = [p.detach().float().clone() for p in state.params]
        step = make_train_step(loss_cfg, tcfg, Normalizer(*stats, device=dev))
        n0 = (at.attention_train_fwd.launches,
              at.attention_train_fwd.f32_launches)
        with RowMaxima() as rec:
            state, m = step(state, hr, lr, draws=draws)
        maxima[dev] = rec.calls
        if dev == "cuda":
            torch.cuda.synchronize()
        n = (at.attention_train_fwd.launches - n0[0],
             at.attention_train_fwd.f32_launches - n0[1])
        want = ((2 * cfg.depth, 2 * cfg.depth if f32 else 0)
                if dev == "cuda" else (0, 0))
        if n != want:
            raise AssertionError(f"{tag} {dev} step: B10 launches {n} (both "
                                 f"modes, fp32) != {want}")
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach().float().cpu() for p in state.params],
                    [mu.float().cpu() for mu in state.opt_state.mu],
                    sorted({f"{p.dtype}/{mu.dtype}/{nu.dtype}" for p, mu, nu
                            in zip(state.params, state.opt_state.mu,
                                   state.opt_state.nu)}),
                    [k for k, _ in state.model.named_parameters()])
        log(f"[{tag} reference] {dev} step ({cfg.depth} blocks) "
            f"{time.perf_counter() - t0:.1f} s:"
            f" loss {out[dev][0]['loss']:.6f}, grad_norm "
            f"{out[dev][0]['grad_norm']:.6f}, parameter/mu/nu dtypes "
            f"{out[dev][3]}")
        del state, step
    (mc, pc, uc, dc, names), (mg, pg, ug, dg, _) = out["cpu"], out["cuda"]
    lr0 = tcfg.lr
    grad_err = max((a - b).abs().max().item() / max(b.abs().max().item(),
                                                     1e-30)
                   for a, b in zip(ug, uc))
    # Each leaf's moments past the bound and their relative L2 difference;
    # (int8) the rows whose maxima moved between the two forwards and the
    # int8 kernels' moments off their column maxima.
    off = [int(((a - b).abs() > bounds["mu"] * b.abs().max()).sum())
           for a, b in zip(ug, uc)]
    l2 = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
          for a, b in zip(ug, uc)]
    moved = moved_rows(torch, maxima["cpu"], maxima["cuda"])
    int8 = [i for i, k in enumerate(names) if INT8_KERNEL.match(k)]
    places = 0
    for i in int8:  # moments off the kernel's column maxima (bf16 cast)
        w = start[i].bfloat16().float().abs()
        top = w == w.amax(dim=0, keepdim=True)
        places += int(((ug[i] != 0) & ~top).sum() + ((uc[i] != 0) & ~top)
                      .sum())
    worst = sorted(range(len(off)), key=lambda i: -off[i])[:6]
    worst_l2 = sorted(range(len(l2)), key=lambda i: -l2[i])[:6]
    # bf16 parameters: the part of each difference past one bf16 ulp.
    d = [((a - b).abs() - (2.0 ** -7 * b.abs() if bounds["ulp"] else 0.0)
          ).clamp(min=0.0) for a, b in zip(pg, pc)]
    p_max = max(x.max().item() for x in d) / lr0
    mean = [(a - b).abs().mean().item() / lr0 for a, b in zip(pg, pc)]
    p_mean = max(mean)
    equal = sum(int((a == b).sum()) for a, b in zip(pg, pc)) \
        / sum(a.numel() for a in pg)
    min_move = min((a - s).abs().max().item()
                   for a, s in zip(pc, start)) / lr0
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gn_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    log(f"[{tag} reference] v3mod2 at {cfg.depth} blocks, batch {REF_B}, "
        f"card vs CPU: loss "
        f"{mg['loss']:.6f} vs {mc['loss']:.6f} (rel {loss_rel:.3e}), "
        f"grad_norm {mg['grad_norm']:.6f} vs {mc['grad_norm']:.6f} (rel "
        f"{gn_rel:.3e}); grads (first moments) max abs {grad_err:.3e} x max,"
        f" elements past {bounds['mu']} x max: {sum(off)} in all, most in "
        f"{[(names[i], off[i], pc[i].numel()) for i in worst]};"
        f" updated params max {p_max:.3f} lr"
        f"{' past one bf16 ulp' if bounds['ulp'] else ''}, worst leaf mean "
        f"{p_mean:.5f} lr ({names[mean.index(p_mean)]}), {100 * equal:.2f} "
        f"% bit-equal; min leaf move "
        f"{min_move:.3f} lr over {len(start)} leaves; bounds {bounds}")
    if bounds.get("count"):
        log(f"[{tag} reference] rows whose maxima moved: {moved} over "
            f"{len(maxima['cpu'])} int8 products; moments off the int8 "
            f"kernels' column maxima: {places} over {len(int8)} kernels; "
            f"each leaf's moments' relative L2 difference, the largest "
            f"{[(names[i], round(l2[i], 5)) for i in worst_l2]}")
        mu_bad = places or max(off) > 2 * moved or max(l2) > bounds["mu_l2"]
    else:
        mu_bad = grad_err > bounds["mu"]
    if (dg != dc or loss_rel > bounds["loss"] or gn_rel > bounds["grad_norm"]
            or mu_bad or p_max > bounds["p_max"]
            or p_mean > bounds["p_mean"] or min_move < 0.5):
        raise AssertionError(f"the card's {tag} step disagrees with the "
                             f"CPU's")


# The training entry point's synthetic data: v3mod2 width (1024 channels,
# fp16), 10 training songs of 2000 frames (60 crops a 6x epoch: two steps
# of 28) and 5 validation songs (30 crops: one batch of 28).
CLI_TRAIN_SONGS, CLI_VAL_SONGS, CLI_FRAMES = 10, 5, 2000
CLI_RUN, TINY_RUN = "01010101", "02020202"
CLI_RUN_NCCL = "01010102"     # the same run under torchrun, NCCL, mesh 1 1


def make_latents(root, C=1024):
    """Seeded fp16 latents under ``root/train`` and ``root/val`` and a stats
    file: what ``python -m jatsr_torch.cli.train --data-dir root`` reads."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    for split, n in (("train", CLI_TRAIN_SONGS), ("val", CLI_VAL_SONGS)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            hr = rng.standard_normal((CLI_FRAMES, C), dtype=np.float32)
            lr = 0.8 * hr + 0.2 * rng.standard_normal((CLI_FRAMES, C),
                                                      dtype=np.float32)
            for name, x in (("hr", hr), ("lr", lr)):
                np.save(root / split / f"song{i:02d}.{name}.npy",
                        x.astype(np.float16))
    (root / "global_stats_separated.json").write_text(json.dumps({
        "hr_mean": (0.05 * rng.standard_normal(C)).tolist(),
        "hr_std": (0.9 + 0.2 * rng.random(C)).tolist(),
        "lr_mean": (0.05 * rng.standard_normal(C)).tolist(),
        "lr_std": (0.7 + 0.2 * rng.random(C)).tolist()}))


class StepClock:
    """Wraps the trainer's step: synchronises after each and records its
    wall time since the previous step returned (the loader's wait and the
    step), so that step times are the card's, not the enqueue's."""

    def __init__(self, torch, step):
        self.torch, self.step, self.times = torch, step, []
        self.t = None

    def __call__(self, *a, **k):
        t0 = self.t if self.t is not None else time.perf_counter()
        out = self.step(*a, **k)
        self.torch.cuda.synchronize()
        self.t = time.perf_counter()
        self.times.append(self.t - t0)
        return out


def state_tensors(state):
    sd = state.state_dict()
    return {**{f"params.{k}": v for k, v in sd["params"].items()},
            **{f"mu.{k}": v for k, v in sd["opt"]["mu"].items()},
            **{f"nu.{k}": v for k, v in sd["opt"]["nu"].items()}}


def cli_train_phase(torch, card, dense_pt):
    """The training entry point at full width: ``python -m
    jatsr_torch.cli.train --preset v3mod2`` (766 M, batch 28 of 1378
    frames, remat "full") for one epoch of seeded latents on the native
    loader (two steps, one validation batch, ``last`` and ``best`` of ~9.2
    GB each: fp32 parameters and two fp32 moments); a fresh ``Trainer``
    resumed from the run (parameters, moments, count and step bit-equal to
    the first trainer's) takes one more step; then a tiny run, trained the
    same way, served by ``python -m jatsr_torch.cli.infer --run-dir`` on a
    ``.npy`` latent, bit-equal to sampling with its restored parameters.
    Every v3mod2 trainer starts from ``dense_pt`` (the serving phase's
    dense weights, saved once; :func:`use_saved_draw`, and this script's
    ``--train-from`` mode under torchrun) instead of a 766 M draw.
    ``[dp nccl]``: the v3mod2 run again under torchrun with ``DP_NCCL`` (NCCL,
    a world of one, ZeRO-1): its ``last`` and ``best`` bit-equal to the
    first run's; resumed under torchrun for its third step, bit-equal to
    the resumed trainer's third step; and ``cli.infer --mesh 1 1`` under
    torchrun on the tiny run, bit-equal to the plain call's wav.
    Everything is written under a temporary directory removed at the end.
    Returns the B10 launches a step and the ``[dp nccl]`` seconds."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np

    from jatsr_torch.cli import infer as infer_cli
    from jatsr_torch.cli import train as train_cli
    from jatsr_torch.configs import Preset, get_preset
    from jatsr_torch.data import load_stats
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.models.dac import DAC
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import dense_tree_from_named
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.ops.attention import gqa_attention_flash
    from jatsr_torch.train import CheckpointManager, Normalizer
    from jatsr_torch.train import loop
    from jatsr_torch.utils.audio_io import load_wav, save_wav
    from jatsr_torch.utils.flops import mfu

    preset = get_preset("v3mod2")
    cfg = preset.model
    n_params = 766e6
    need = 5 * 12 * n_params  # two runs' last and best, and one more
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    free = shutil.disk_usage(tmp).free
    log(f"[cli train] {free / 1e9:.1f} GB free under {tmp}; the checkpoints "
        f"need ~{need / 3e9:.1f} GB each")
    if free < need:
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"{free / 1e9:.1f} GB free, need "
                             f"{need / 1e9:.1f}")
    cwd = os.getcwd()
    clocks = []
    real_step, loop_draw = loop.make_train_step, loop.init_dense_params

    def clocked(*a, **k):
        clocks.append(StepClock(torch, real_step(*a, **k)))
        return clocks[-1]

    try:
        t0 = time.perf_counter()
        make_latents(tmp / "data")
        log(f"[cli train] latents: {time.perf_counter() - t0:.1f} s")
        # Each v3mod2 trainer below (the CLI's, torchrun's two and the
        # resumed one) starts from the serving phase's dense weights, saved
        # once (``dense_pt``), instead of drawing 766 M weights from the
        # seed: in this process by use_saved_draw, under torchrun by this
        # script's --train-from mode.
        drawn = use_saved_draw(torch, dense_pt)
        train_saved = [str(Path(__file__).resolve()), "--train-from",
                       str(dense_pt)]
        os.chdir(tmp)  # the run goes under ./checkpoints/<preset>/<run>
        loop.make_train_step = clocked
        counters = (at.attention_train_fwd, at.attention_train_bwd,
                    gqa_attention_flash)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        first = train_cli.main([
            "--preset", "v3mod2", "--data-dir", str(tmp / "data"),
            "--epochs", "1", "--native-loader", "--run-name", CLI_RUN])
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        steps = first.steps_done
        run = tmp / "checkpoints" / "v3mod2" / CLI_RUN
        per_step = {"attention_train_fwd": launches[0] / steps,
                    "attention_train_bwd": launches[1] / steps}
        times = clocks[-1].times
        log(f"[cli train] {steps} steps, B10 launches a step {per_step} "
            f"(expected 56 and 28); validation ({len(first.val_loader)} "
            f"batch) takes the einsum attention of attention_impl "
            f"{cfg.attention_impl!r}: split flash launches {launches[2]}; "
            f"{wall:.1f} s in all (the saved weights, data, steps, "
            f"validation, saves)")
        if (steps != 2 or per_step != {"attention_train_fwd": 2 * cfg.depth,
                                       "attention_train_bwd": cfg.depth}
                or launches[2] != 0):
            raise AssertionError(f"CLI run: {steps} steps, launches "
                                 f"{launches}")
        flops = first._flops_per_step
        log(f"[cli train] {card}: step ms (loader wait + step, synchronised) "
            f"{[round(t * 1e3, 1) for t in times]}; second step "
            f"{times[-1] * 1e3:.1f} ms, {TRAIN_B / times[-1]:.2f} samples/s, "
            f"MFU {mfu(flops, times[-1]):.4f}; loader wait "
            f"{first.loader_wait_s * 1e3:.1f} ms over {steps} steps "
            f"({first.loader_wait_s / sum(times):.4f} of the steps' time)")
        for op, name, nbytes, sec in first.ckpt.io:
            log(f"[cli train] {card}: {op} {name}: {nbytes / 1e9:.3f} GB in "
                f"{sec:.2f} s ({nbytes / 1e9 / sec:.2f} GB/s)")
        for name in ("last", "best", "preset.json", "last.meta.json",
                     "best.meta.json"):
            if not (run / name).exists():
                raise AssertionError(f"the run lacks {name}")

        # [dp nccl]: the same call under torchrun on a mesh of one.
        nccl = {"train_s": torchrun([
            *train_saved, "--preset", "v3mod2", "--data-dir",
            str(tmp / "data"), "--epochs", "1", "--native-loader",
            "--run-name", CLI_RUN_NCCL, *DP_NCCL], tmp)}
        run_nccl = run.parent / CLI_RUN_NCCL
        for name in ("last", "best"):
            ok, n = same_checkpoint(torch, run / name, run_nccl / name)
            log(f"[dp nccl] torchrun cli.train {' '.join(DP_NCCL)}: {name} "
                f"bit-equal to the plain run's ({n} tensors, meta): {ok}")
            if not ok:
                raise AssertionError(f"[dp nccl] {name} differs")
        # Nothing reads the two ``best`` again: free their 18.4 GB before
        # the resumed run writes its ``last`` (the card machine's disk
        # takes 45 GiB of writes a call; freed blocks are written again
        # only once the deletes are synced).
        for r in (run, run_nccl):
            shutil.rmtree(r / "best")
        os.sync()

        # A fresh trainer resumes from the run directory.
        loop.make_train_step = real_step
        t0 = time.perf_counter()
        second = loop.Trainer(Preset.from_json((run / "preset.json")
                                               .read_text()),
                              data_dir=str(tmp / "data"), resume=str(run),
                              native_loader=True)
        log(f"[cli train] resumed trainer: {time.perf_counter() - t0:.1f} s "
            f"(the saved weights, restore)")
        for op, name, nbytes, sec in second.ckpt.io:
            log(f"[cli train] {card}: {op} {name}: {nbytes / 1e9:.3f} GB in "
                f"{sec:.2f} s ({nbytes / 1e9 / sec:.2f} GB/s)")
        a, b = state_tensors(first.state), state_tensors(second.state)
        same = [k for k in a if torch.equal(a[k], b[k])]
        log(f"[cli train] restore: {len(same)} of {len(a)} tensors "
            f"bit-equal; step {second.state.step} vs {first.state.step}, "
            f"count {second.state.opt_state.count} vs "
            f"{first.state.opt_state.count}, start epoch "
            f"{second.start_epoch}")
        if (len(same) != len(a) or second.state.step != first.state.step
                or second.state.opt_state.count
                != first.state.opt_state.count or second.start_epoch != 1):
            raise AssertionError("the resumed state differs")
        del first, a, b
        gc.collect()
        torch.cuda.empty_cache()
        second.train_loader.set_epoch(1)
        hr, lr = second._ready(*next(iter(second.train_loader)))
        t0 = time.perf_counter()
        state, m = second.train_step(second.state, hr, lr)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        log(f"[cli train] one more step: {ms:.1f} ms, loss {loss:.5f}, "
            f"step {state.step}")
        if not math.isfinite(loss) or state.step != 3:
            raise AssertionError(f"the resumed step: loss {loss}")
        del hr, lr
        nccl["resume_s"] = torchrun([
            *train_saved, "--preset", "v3mod2", "--data-dir",
            str(tmp / "data"), "--native-loader", "--resume", str(run_nccl),
            "--max-steps", "3", "--save-best-every", "1000", *DP_NCCL], tmp)
        blob = CheckpointManager(run_nccl, primary=False).load("last",
                                                              "cuda")
        mine = state_tensors(state)
        theirs = {**{f"params.{k}": v for k, v in
                     blob["state"]["params"].items()},
                  **{f"{m}.{k}": v for m in ("mu", "nu")
                     for k, v in blob["state"]["opt"][m].items()}}
        same = [k for k in mine if torch.equal(mine[k], theirs[k])]
        log(f"[dp nccl] torchrun --resume to step 3: {len(same)} of "
            f"{len(mine)} tensors bit-equal to the resumed trainer's step; "
            f"step {blob['state']['step']}; {nccl['resume_s']:.1f} s")
        if (len(same) != len(mine) or mine.keys() != theirs.keys()
                or blob["state"]["step"] != 3):
            raise AssertionError("[dp nccl] the resumed run differs")
        del second, state, blob, mine, theirs
        gc.collect()
        torch.cuda.empty_cache()

        # A tiny run (drawn from its seed), served from its run directory.
        loop.init_dense_params = drawn
        train_cli.main(["--preset", "tiny", "--data-dir", str(tmp / "data"),
                        "--max-steps", "2", "--run-name", TINY_RUN])
        tiny = tmp / "checkpoints" / "tiny" / TINY_RUN
        latent = np.load(tmp / "data" / "val" / "song00.lr.npy")[:300]
        np.save(tmp / "song.lr.npy", latent)
        stats = tmp / "data" / "global_stats_separated.json"
        infer_cli.main(["--run-dir", str(tiny), "--stats", str(stats),
                        "--input", str(tmp / "song.lr.npy"), "--output-dir",
                        str(tmp / "out"), "--steps", "2", "--cfg-scale",
                        "2.0"])
        got, _ = load_wav(tmp / "out" / "song.lr_generated_cfg2.0.wav")
        nccl["infer_s"] = torchrun([
            "-m", "jatsr_torch.cli.infer", "--run-dir", str(tiny), "--stats",
            str(stats), "--input", str(tmp / "song.lr.npy"), "--output-dir",
            str(tmp / "out_nccl"), "--steps", "2", "--cfg-scale", "2.0",
            "--mesh", "1", "1"], tmp)
        got_nccl, _ = load_wav(tmp / "out_nccl" /
                               "song.lr_generated_cfg2.0.wav")
        log(f"[dp nccl] torchrun cli.infer --mesh 1 1 on the tiny run: equal "
            f"to the plain call's wav: {bool(np.array_equal(got, got_nccl))};"
            f" {nccl['infer_s']:.1f} s; the train call {nccl['train_s']:.1f} "
            f"s")
        if not np.array_equal(got, got_nccl):
            raise AssertionError("[dp nccl] cli.infer --mesh 1 1 differs")
        tp = Preset.from_json((tiny / "preset.json").read_text())
        model = DenseDiT(
            dataclasses.replace(tp.model, attention_impl="xla", dropout=0.0,
                                drop_path_rate=0.0),
            dense_tree_from_named(CheckpointManager(tiny, primary=False)
                                  .load("best")["state"]["params"], tp.model),
            device="cuda")
        pipe = InferencePipeline(
            model, Normalizer(*load_stats(stats)),
            DAC.random_init(0, fused_res_units=True, device="cuda"),
            dataclasses.replace(tp.sampler, num_steps=2, cfg_scale=2.0))
        save_wav(tmp / "want.wav", pipe.decode_latent(
            pipe.super_resolve_latent(latent.astype(np.float32), 0, 2, 2.0)),
            44100)
        want, _ = load_wav(tmp / "want.wav")
        log(f"[cli infer] --run-dir {tiny.name} (tiny, best): "
            f"{got.shape[0]} samples, equal to the library's: "
            f"{bool(np.array_equal(got, want))}")
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("cli.infer --run-dir differs from sampling "
                                 "with the run's parameters")
        return per_step, nccl
    finally:
        loop.make_train_step = real_step
        loop.init_dense_params = loop_draw
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def use_saved_draw(torch, path):
    """Make the trainers this process builds start from the dense tree
    saved at ``path`` (``torch.save`` of the draw) instead of the draw
    ``train/loop.py`` makes from the seed (766 M weights: ~4 s of CPU a
    trainer); returns the drawing function it replaced."""
    from jatsr_torch.train import loop

    drawn = loop.init_dense_params
    loop.init_dense_params = lambda cfg, generator: torch.load(
        path, mmap=True, weights_only=True)
    return drawn


def train_from_saved(path, argv) -> int:
    """``python -m jatsr_torch.cli.train argv`` whose trainers start from
    the dense tree saved at ``path``: this script's mode under torchrun,
    ``chip_smoke.py --train-from PATH ARGS``."""
    import torch

    from jatsr_torch.cli import train as train_cli

    use_saved_draw(torch, path)
    train_cli.main(argv)
    return 0


# The data-preparation corpus: (name, rate, seconds) of synthetic songs at
# the rates users bring.  "long" is nine 8 s windows (7 s valid + 0.5 s
# context each side; the JAX package pads the count to 16), "short" is
# under DataConfig.min_duration (1 s) and is skipped.
CORPUS = (("long", 48000, 60.0), ("b", 44100, 12.0), ("c", 48000, 20.0),
          ("d", 44100, 5.0), ("short", 48000, 0.5))
# The card-vs-CPU song (8 s at 48 kHz) runs at DataConfig's own windows: two
# 8 s windows, stitched and trimmed as the corpus is (~1.8 TFLOP on the
# CPU).  Frames with the same codes agree within one fp16 ulp + 1e-5 x max
# |z| (the projection of the same codebook rows, sums in another order).
# The quantizer works frame by frame, so a code flipped by a distance tie
# that fp32 rounding breaks the other way moves that one frame only: 1 %
# of the frames allows a few such ties (none seen in 260 frames at 1 s
# chunks, PERF.md), while a fault in one window or in the trim moves half
# of the song's frames.
PREP_FRAMES_OFF = 0.01
LATENT = 1024  # the 44.1 kHz codec's latent channels


def write_corpus(root):
    """The corpus as float32 WAVs under ``root`` (two tones a song and
    noise, from the seed)."""
    import numpy as np

    from jatsr_torch.utils.audio_io import save_wav

    rng = np.random.default_rng(SEED + 31)
    for i, (name, sr, secs) in enumerate(CORPUS):
        t = np.arange(int(sr * secs)) / sr
        save_wav(root / f"{name}.wav", (
            0.3 * np.sin(2 * np.pi * (220 + 55 * i) * t)
            + 0.1 * np.sin(2 * np.pi * (6000 + 500 * i) * t)
            + 0.03 * rng.standard_normal(len(t))).astype(np.float32), sr)


def check_prepared(out):
    """What a prepare run wrote: every song but "short" done, "short"
    skipped, no error line; fp16 ``[frames, LATENT]`` latents (frames as the
    metadata says, within 0.2 % of duration x 44100 / 512: the trim's hop
    is measured on the padded window, 690 frames for 689.06); the port's
    ``LatentDataset`` and ``load_stats`` read them.  Returns the songs'
    seconds."""
    import numpy as np

    from jatsr_torch.data import LatentDataset, load_stats

    lines = [json.loads(x) for x in
             (out / "processed_files.jsonl").read_text().splitlines()]
    status = {Path(e["path"]).stem: e["status"] for e in lines}
    want = {name: "skipped" if name == "short" else "done"
            for name, _, _ in CORPUS}
    if status != want or any(e["status"] == "error" for e in lines):
        raise AssertionError(f"prepare: log {lines}")
    seconds = 0.0
    for meta in out.glob("*/*.meta.json"):
        m = json.loads(meta.read_text())
        base = str(meta).removesuffix(".meta.json")
        for part in ("hr", "lr"):
            z = np.load(f"{base}.{part}.npy")
            if (z.dtype != np.float16 or z.shape != (m["frames"], LATENT)
                    or not np.isfinite(z).all()
                    or abs(m["frames"] / (m["duration"] * 44100 / 512) - 1)
                    > 2e-3):
                raise AssertionError(f"prepare: {base}.{part}.npy {z.dtype} "
                                     f"{z.shape}, meta {m}")
        seconds += m["duration"]
    stats = load_stats(str(out / "global_stats_separated.json"))
    ds = LatentDataset(str(out), "train", target_frames=1378)
    hr, lr = ds[0]
    if (hr.shape != (1378, LATENT) or stats[0].shape != (LATENT,)
            or not (stats[1] > 0).all()):
        raise AssertionError(f"prepare: dataset {hr.shape}, stats "
                             f"{stats[0].shape}")
    for name in ("running_stats.npz", "global_stats.json"):
        if not (out / name).exists():
            raise AssertionError(f"prepare: no {name}")
    return seconds


def prepare_phase(torch, card):
    """``python -m jatsr_torch.cli.prepare_dataset`` at the full width of the
    44.1 kHz codec (random weights from seed 0, as the CLI takes without
    ``--dac-weights``) on CORPUS: the log, the files and their shapes, the
    dataset and stats reading them, audio-sec/s and the peak memory; a
    second run encodes nothing.  Then the prefetch overlap: the pipeline
    in turns without and with its prefetch thread (P S S P), each run's
    latents bit-equal to the CLI's; the 60 s song alone (its peak memory);
    and the card against the CPU plain path on one song."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from jatsr_torch.cli import prepare_dataset
    from jatsr_torch.configs import DataConfig
    from jatsr_torch.data import PreprocessPipeline
    from jatsr_torch.models.dac import DAC
    from jatsr_torch.utils.audio_io import save_wav

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_prepare_"))
    try:
        write_corpus(tmp / "src")
        total = sum(secs for name, _, secs in CORPUS if name != "short")
        args = ["--source-dirs", str(tmp / "src"), "--output-dir",
                str(tmp / "out")]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        counts = prepare_dataset.main(args)
        t_cli = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if counts != {"done": 4, "skipped": 1, "error": 0}:
            raise AssertionError(f"prepare: counts {counts}")
        seconds = check_prepared(tmp / "out")
        log(f"[prepare] cli: {len(CORPUS) - 1} songs, {seconds:.1f} audio-s "
            f"in {t_cli:.2f} s ({seconds / t_cli:.1f} audio-sec/s, codec "
            f"build and first calls in it), peak {peak:.2f} GiB; {card}")
        t0 = time.perf_counter()
        again = prepare_dataset.main(args)
        log(f"[prepare] second run: {again} in "
            f"{time.perf_counter() - t0:.2f} s")
        if again != {"done": 0, "skipped": 1, "error": 0}:
            raise AssertionError(f"prepare: the second run {again}")

        codec = DAC.random_init(0, device="cuda")
        ref = {p.name: np.load(p) for p in (tmp / "out").glob("*/*.npy")}
        runs = {"prefetch": [], "serial": []}
        for i, mode in enumerate(("prefetch", "serial", "serial",
                                  "prefetch")):
            out = tmp / f"ab{i}"
            pipe = PreprocessPipeline(codec, DataConfig(), str(out))
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                counts = pipe.run([str(tmp / "src")], verbose=False,
                                  prefetch=mode == "prefetch")
                torch.cuda.synchronize()
                runs[mode].append(time.perf_counter() - t0)
            names = {p.name for p in out.glob("*/*.npy")}
            if (counts != {"done": 4, "skipped": 1, "error": 0}
                    or names != set(ref)):
                raise AssertionError(f"prepare: {mode} run {counts}, wrote "
                                     f"{sorted(names)}, the CLI "
                                     f"{sorted(ref)}")
            for p in out.glob("*/*.npy"):
                if not np.array_equal(np.load(p), ref[p.name]):
                    raise AssertionError(f"prepare: {mode} {p.name} differs "
                                         f"from the CLI's")
            shutil.rmtree(out)
        rate = {k: [round(total / t, 1) for t in v] for k, v in runs.items()}
        log(f"[prepare] overlap A/B (P S S P), {total:.1f} audio-s a run: "
            f"prefetch s {[round(t, 3) for t in runs['prefetch']]} "
            f"({rate['prefetch']} audio-sec/s), serial s "
            f"{[round(t, 3) for t in runs['serial']]} ({rate['serial']} "
            f"audio-sec/s); latents bit-equal to the CLI's; {card}")

        pipe = PreprocessPipeline(codec, DataConfig(), str(tmp / "one"))
        prepared = pipe._prepare_song(str(tmp / "src" / "long.wav"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        z = pipe._dispatch_encode(prepared)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        hr, _, meta = pipe._finalize_encode(str(tmp / "src" / "long.wav"),
                                            prepared, z)
        log(f"[prepare] the 60 s song alone: {z[0].shape[0]} windows of "
            f"{z[2]} samples, resample, window and encode {t_enc * 1e3:.1f} ms "
            f"({60.0 / t_enc:.1f} audio-sec/s), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{hr.shape[0]} frames; {card}")
        if not np.array_equal(hr, ref["long.hr.npy"]):
            raise AssertionError("prepare: the 60 s song alone differs")

        rng = np.random.default_rng(SEED + 32)
        t = np.arange(8 * 48000) / 48000
        save_wav(tmp / "ref" / "song.wav", (
            0.3 * np.sin(2 * np.pi * 500 * t)
            + 0.03 * rng.standard_normal(len(t))).astype(np.float32), 48000)
        cfg = DataConfig()
        got = PreprocessPipeline(codec, cfg, str(tmp / "ref" / "card")
                                 ).process_song(str(tmp / "ref" / "song.wav"))
        cpu = DAC.random_init(0, device="cpu")
        t0 = time.perf_counter()
        want = PreprocessPipeline(cpu, cfg, str(tmp / "ref" / "cpu")
                                  ).process_song(str(tmp / "ref" / "song.wav"))
        t_cpu = time.perf_counter() - t0
        off = []
        for g, w in zip(got[:2], want[:2]):
            w64 = w.astype(np.float64)
            tol = (np.spacing(np.abs(w)).astype(np.float64)
                   + 1e-5 * np.abs(w64).max())
            bad = (np.abs(g.astype(np.float64) - w64) > tol).any(axis=1)
            off.append(int(bad.sum()))
        n = got[0].shape[0]
        log(f"[prepare] one song (8 s at 48 kHz, two configured 8 s "
            f"windows), card vs CPU plain path ({t_cpu:.1f} s of CPU): "
            f"{got[0].shape} fp16; frames beyond one fp16 ulp + 1e-5 x max: "
            f"HR {off[0]}, LR {off[1]} of {n} (bound "
            f"{PREP_FRAMES_OFF:.0%}: a code flipped)")
        if (got[0].shape != want[0].shape or got[2] != want[2]
                or max(off) > PREP_FRAMES_OFF * n):
            raise AssertionError(f"prepare: card vs CPU {off} of {n} frames")
        return {"cli_s": t_cli, "audio_s": seconds, "peak_gib": peak,
                "prefetch_s": runs["prefetch"], "serial_s": runs["serial"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def remat_phase(torch, dense, card, profile=False):
    """Two v3mod2 steps at batch 28 (dropout 0.1, drop-path 0.05, warmup
    0) under each remat policy, from the same weights, batch and draws:
    the first step's B10 launches (forward 28 under "none", 56 under the
    others; backward 28), parameters (within the card-step bounds of those
    under "none": 2 lr at most, 2 % of lr on average) and peak memory over
    what was allocated before it (the gradients and what the policy keeps
    for backward), the second step's time (the first grows the allocator's
    pool for the policy's activations).  With ``profile`` a third step of
    each is traced."""
    import gc

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    preset = get_preset("v3mod2")
    tcfg = dataclasses.replace(preset.train, warmup_steps=0)
    hr, lr, stats = train_batch(torch, preset.model)
    out = {}
    for policy in ("none", "full", "dots", "attn_out", "mlp"):
        cfg = dataclasses.replace(preset.model, remat_policy=policy)
        state = create_train_state(DenseDiT(cfg, dense, device="cuda"),
                                   tcfg, 1000, (hr, lr), device="cuda")
        step = make_train_step(preset.loss, tcfg, Normalizer(*stats))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n0 = (at.attention_train_fwd.launches, at.attention_train_bwd.launches)
        t0 = time.perf_counter()
        state, m = step(state, hr, lr)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        n = (at.attention_train_fwd.launches - n0[0],
             at.attention_train_bwd.launches - n0[1])
        peak = torch.cuda.max_memory_allocated()
        params = [p.detach().clone() for p in state.params]
        out[policy] = params
        t0 = time.perf_counter()
        state, m2 = step(state, hr, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gib = 2.0 ** 30
        log(f"[remat] {card}: {policy}: second step {ms:.1f} ms (first "
            f"{first:.1f}), first step's peak {peak / gib:.2f} GiB "
            f"({(peak - base) / gib:.2f} GiB over the {base / gib:.2f} GiB "
            f"before it: the state, the batch, the parameters of 'none' "
            f"kept to compare), B10 launches "
            f"a step forward {n[0]}, backward {n[1]}, loss "
            f"{float(m['loss']):.6f}, {float(m2['loss']):.6f}")
        want = ((1 if policy == "none" else 2) * cfg.depth, cfg.depth)
        if n != want:
            raise AssertionError(f"remat {policy}: launches {n} != {want}")
        if policy != "none":
            pairs = list(zip(params, out["none"]))
            p_max = max((a - b).abs().max().item() for a, b in pairs) \
                / tcfg.lr
            p_mean = max((a - b).abs().mean().item() for a, b in pairs) \
                / tcfg.lr
            equal = all(torch.equal(a, b) for a, b in zip(params,
                                                         out["none"]))
            log(f"[remat] {policy} against none: parameters max "
                f"{p_max:.4f} lr, worst leaf mean {p_mean:.6f} lr, "
                f"bit-equal {equal}")
            if p_max > 2.02 or p_mean > 0.02:
                raise AssertionError(f"remat {policy} moves the step")
            del out[policy], pairs
        if profile:
            profile_phase(torch, f"remat {policy} step",
                          lambda: step(state, hr, lr))
        del state, step, params
        gc.collect()
        torch.cuda.empty_cache()


# B10 at a batch offset: the rows of the v3 training batch a second rank of
# two holds (rows 14-27, b0 = 14).
B10_OFFSET = TRAIN_B // 2


def check_attention_train_offset(torch, checks):
    """B10 as a data-parallel rank launches it: rows ``B10_OFFSET ..`` of
    the v3 training batch (q [14, 345, 1280], dropout 0.1) with the batch
    offset ``b0 = 14``, bf16 and fp32, forward and backward.  Each is
    bit-equal to those rows of a launch over the whole batch (a CTA reads
    only its (batch, head); the offset keys the dropout hash by the global
    row) and within the plain version's bounds above at that offset; a
    launch at ``b0 = 0`` on the same rows differs.  Timed at ``b0 = 14``
    and ``b0 = 0`` on the same 14 rows in turns (0, 14, 14, 0): the offset
    argument's cost.  Adds a ``batch_offset`` entry to each B10 line."""
    from jatsr_torch.ops import attention_train as at

    hq, hkv, D, rate, seed = 20, 4, 64, 0.1, -123456789
    b0 = B10_OFFSET
    for dt, suffix in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
        q, k, v, do = (torch.randn((TRAIN_B, TRAIN_N, w * D), generator=gen,
                                   device="cuda").to(dt)
                       for w in (hq, hkv, hkv, hq))
        o, stats = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate)
        full = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate,
                                      stats)
        part_in = [t[b0:].contiguous() for t in (q, k, v, do)]
        qs, ks, vs, dos = part_in
        o1, st1 = at.attention_train_fwd(qs, ks, vs, seed, hq, hkv, rate,
                                         b0=b0)
        part = at.attention_train_bwd(qs, ks, vs, o1, dos, seed, hq, hkv,
                                      rate, st1, b0=b0)
        o0, _ = at.attention_train_fwd(qs, ks, vs, seed, hq, hkv, rate)
        torch.cuda.synchronize()
        what = f"B10{suffix} at b0 {b0}"
        if not (torch.equal(o1, o[b0:]) and torch.equal(st1, stats[b0:])
                and all(torch.equal(a, f[b0:]) for a, f in zip(part, full))):
            raise AssertionError(f"{what}: not the whole batch's rows")
        if torch.equal(o0, o1):
            raise AssertionError(f"{what}: the offset leaves the output")
        want = at.attention_train_fwd_plain(qs, ks, vs, seed, hq, hkv, rate,
                                            b0=b0)
        ref = at.attention_train_bwd_plain(qs, ks, vs, o1, dos, seed, hq,
                                           hkv, rate, b0=b0)
        err_f = (o1.float() - want.float()).abs().max().item()
        if suffix and err_f > REL_F32_TRAIN * want.abs().max().item():
            raise AssertionError(f"{what} forward: max abs {err_f}")
        if not suffix:
            torch.testing.assert_close(o1.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
        err_b = 0.0
        for name, a, r in zip(("dq", "dk", "dv"), part, ref):
            e = (a.float() - r.float()).abs().max().item()
            lim = (REL_F32_TRAIN if suffix else REL_ATTN_BWD) \
                * r.float().abs().max().item()
            if e > lim:
                raise AssertionError(f"{what} backward {name}: max abs {e} "
                                     f"> {lim}")
            err_b = max(err_b, e)
        del o, stats, full, want, ref, o0, q, k, v, do
        ms = {"fwd": {0: [], b0: []}, "bwd": {0: [], b0: []}}
        for off in (0, b0, b0, 0):
            ms["fwd"][off].append(time_ms(lambda *_: at.attention_train_fwd(
                qs, ks, vs, seed, hq, hkv, rate, b0=off), [()], 30))
            ms["bwd"][off].append(time_ms(lambda *_: at.attention_train_bwd(
                qs, ks, vs, o1, dos, seed, hq, hkv, rate, st1, b0=off),
                [()], 20))
        for way, err in (("fwd", err_f), ("bwd", err_b)):
            line = checks[f"attention_train_{way}{suffix}"]
            t0, t1 = (sum(ms[way][x]) / 2 for x in (0, b0))
            line["batch_offset"] = {
                "shape": [TRAIN_B - b0, TRAIN_N, hq, hkv, D], "b0": b0,
                "max_abs_err": err, "ms": t1, "ms_b0_0": t0,
                "turns_ms": ms[way][0][:1] + ms[way][b0] + ms[way][0][1:],
                "whole_batch_rows_bit_equal": True}
            log(f"[kernel] attention_train_{way}{suffix} at b0 {b0}: "
                f"{t1:.5f} ms against {t0:.5f} at b0 0 on the same "
                f"{TRAIN_B - b0} rows ({(t1 / t0 - 1) * 100:+.2f} %), max "
                f"abs {err:.3g}, rows bit-equal to the whole batch's")
        del qs, ks, vs, dos, o1, st1, part
        torch.cuda.empty_cache()


# [dp shared card]: two data-parallel ranks on the one card of this machine,
# over gloo (NCCL refuses two ranks on one GPU), spawned after the parent
# has built the kernels (the ranks load that build) and freed its models.
# Against the parent's single-card runs on the same weights and inputs:
# (a) two v3mod2 steps at the global batch of 28 (14 a rank), remat "full",
# dropout 0.1, drop-path 0.05, the loss the reconstruction (MSE) alone, as
# in check_train_reference: under the preset's perceptual stack the
# log-magnitude gradient 1 / |rfft(pred)| turns the last-bit differences of
# a prediction at 14 rows (cuBLAS's bf16 GEMMs take other algorithms than
# at 28) into gradients tens of percent apart on some bins (with it, on an
# NVIDIA H100 80GB HBM3 at 700 W: grad norms 1.6e-3 and 3.4e-3 apart, the
# worst leaf's parameters 0.073 lr apart on average).  Bounds: the loss
# within rtol 2e-4 (the JAX package's bound for its mesh step), the grad
# norm within 1e-3, the parameters within DP_PARAM_BOUNDS in units of the
# steps' summed learning rate: a rank's weight gradients are its rows' bf16
# sums before the all-reduce adds them, so a gradient near 0 can take
# Adam's +-lr step the other way (2 lr a step; 2 % of lr on average, the
# CPU test's bound).  Both ranks' parameters bit-equal.  (b) The same steps
# under ZeRO-1, bit-equal to (a).  (c) The main path's sampler pass over
# the 3790-frame latent at STEPS steps on a (2, 1) mesh (the group of three
# chunks padded to four, two a rank), against the single-card pass:
# bit-equal, or within the JAX package's pipeline bound (atol 2e-2,
# relative L2 5e-2) with the difference reported.
DP_RANKS = 2
DP_STEPS = 2
DP_PARAM_BOUNDS = dict(p_max=2.02, p_mean=0.02)
DP_SERVE_ATOL, DP_SERVE_REL_L2 = 2e-2, 5e-2


def dp_train_inputs(torch):
    """v3mod2 as chip_smoke trains it, its batch, the step's config and the
    reconstruction loss."""
    from jatsr_torch.configs import get_preset

    preset = get_preset("v3mod2")
    tcfg = dataclasses.replace(preset.train, warmup_steps=TRAIN_WARMUP)
    loss = dataclasses.replace(preset.loss, use_latent_perceptual=False)
    hr, lr, stats = train_batch(torch, preset.model)
    return preset, tcfg, loss, hr, lr, stats


def dp_serve_inputs(torch):
    """The main path's DiT config and its latent, as ``main`` draws it."""
    from jatsr_torch.configs import get_preset

    cfg = dataclasses.replace(get_preset("v3").model,
                              **{**SERVING, **PATHS["prologue"]})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.randn((LATENT_FRAMES, cfg.input_channels), generator=gen,
                     device="cuda")
    return cfg, lr


def dp_pipeline(model, mesh=None):
    import numpy as np

    from jatsr_torch.configs import SamplerConfig
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.train.step import Normalizer

    C = model.cfg.input_channels
    return InferencePipeline(
        model, Normalizer(np.zeros(C), np.ones(C), np.zeros(C), np.ones(C)),
        None, SamplerConfig(num_steps=STEPS, cfg_scale=CFG_SCALE),
        mesh=mesh)


def dp_steps(torch, state, step, hr, lr):
    """``DP_STEPS`` steps, each synchronised: losses, grad norms and ms."""
    losses, norms, times = [], [], []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, hr, lr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, times


def dp_rank(rank, root, weights):
    """One rank of ``[dp shared card]``: (a), (b) and (c) of the comment
    above on its rows, the results into ``root/rank<r>.json``."""
    import gc
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from jatsr_torch.models.dit import DenseDiT, DiT
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.parallel import (DataGroup, batch_rows, init_distributed,
                                      make_mesh)
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    root = Path(root)
    init_distributed(f"file://{root}/store", DP_RANKS, rank, local_rank=rank,
                     backend="gloo", device="cuda")
    mesh = make_mesh(DP_RANKS, 1, device="cuda")
    dp = DataGroup(mesh)
    out = {"rank": rank, "card": torch.cuda.current_device(),
           "backend": dist.get_backend(), "mesh": list(mesh.shape)}
    preset, tcfg, loss, hr, lr, stats = dp_train_inputs(torch)
    rows = batch_rows(mesh, TRAIN_B)
    hr, lr = hr[rows].contiguous(), lr[rows].contiguous()
    out["rows"] = [rows.start, rows.stop]
    dense = torch.load(Path(weights) / "dense.pt", mmap=True,
                       weights_only=True)
    finals = {}
    for zero in (False, True):
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(
            DenseDiT(preset.model, dense, device="cuda"), tcfg, 1000,
            (hr, lr), device="cuda", mesh=mesh, shard_opt_state=zero)
        step = make_train_step(loss, tcfg, Normalizer(*stats), mesh=mesh)
        at.attention_train_fwd.launches = at.attention_train_bwd.launches = 0
        losses, norms, times = dp_steps(torch, state, step, hr, lr)
        finals[zero] = [p.detach().clone() for p in state.params]
        names = [k for k, _ in state.model.named_parameters()]
        lr_sum = sum(float(state.tx.schedule(i)) for i in range(DP_STEPS))
        out["zero" if zero else "plain"] = {
            "losses": losses, "grad_norms": norms, "ms": times,
            "launches": [at.attention_train_fwd.launches,
                         at.attention_train_bwd.launches],
            "moment_elements": sum(m.numel() for m in state.opt_state.mu),
            "peak_gib": torch.cuda.max_memory_allocated() / 2.0 ** 30}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    del dense
    out["zero_bit_equal"] = all(torch.equal(a, b) for a, b in
                                zip(finals[False], finals[True]))
    same = True
    for p in finals[False]:
        buf = p.clone()
        dp.broadcast_(buf)
        same = same and torch.equal(buf, p)
    out["ranks_bit_equal"] = same
    if rank == 0:
        ref = torch.load(root / "ref_params.pt")
        leaves, past, n = [], 0, 0
        for name, p, r in zip(names, finals[False], ref):
            d = (p - r.to(p.device)).abs()
            leaves.append((d.mean().item(), d.max().item(), name))
            past += int((d > lr_sum).sum())
            n += d.numel()
        leaves.sort(reverse=True)
        out["vs_single"] = {"max": max(x[1] for x in leaves),
                            "worst_mean": leaves[0][0],
                            "worst_leaves": leaves[:4],
                            "share_past_lr": past / n}
        del ref
    del finals
    gc.collect()
    torch.cuda.empty_cache()

    cfg, latent = dp_serve_inputs(torch)
    static = torch.load(Path(weights) / "static.pt", mmap=True,
                        weights_only=True)
    pipe = dp_pipeline(DiT(cfg, static, device="cuda"), mesh)
    del static
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipe.super_resolve_latent_device(latent, SEED, STEPS, CFG_SCALE,
                                           max_batch=3)
    torch.cuda.synchronize()
    out["serve_ms"] = (time.perf_counter() - t0) * 1e3
    want = torch.load(root / "ref_serve.pt").to(got.device)
    diff = (got - want).abs()
    out["serve"] = {"shape": list(got.shape),
                    "finite": bool(torch.isfinite(got).all()),
                    "bit_equal": bool(torch.equal(got, want)),
                    "max_abs": diff.max().item(),
                    "rel_l2": ((got - want).norm() / want.norm()).item(),
                    "differing": (diff > 0).float().mean().item()}
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def dp_shared_card_phase(torch, dense, static, card, weights):
    """``[dp shared card]``: the parent's single-card references, then the
    two ranks (:func:`dp_rank`) on this card, then their results checked."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    from jatsr_torch.models.dit import DenseDiT, DiT
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        t0 = time.perf_counter()
        preset, tcfg, loss, hr, lr, stats = dp_train_inputs(torch)
        state = create_train_state(
            DenseDiT(preset.model, dense, device="cuda"), tcfg, 1000,
            (hr, lr), device="cuda")
        step = make_train_step(loss, tcfg, Normalizer(*stats))
        lr_sum = sum(float(state.tx.schedule(i)) for i in range(DP_STEPS))
        losses, norms, times = dp_steps(torch, state, step, hr, lr)
        torch.save([p.detach().cpu() for p in state.params],
                   root / "ref_params.pt")
        del state, step, hr, lr
        gc.collect()
        torch.cuda.empty_cache()
        cfg, latent = dp_serve_inputs(torch)
        pipe = dp_pipeline(DiT(cfg, static, device="cuda"))
        ref = pipe.super_resolve_latent_device(latent, SEED, STEPS,
                                               CFG_SCALE, max_batch=3)
        torch.save(ref.cpu(), root / "ref_serve.pt")
        del pipe, ref, latent
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[dp shared card] single-card references: losses {losses}, "
            f"grad norms {norms}, ms {[round(t, 1) for t in times]}; inputs "
            f"written; "
            f"{time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        mp.start_processes(dp_rank, args=(str(root), str(weights)),
                           nprocs=DP_RANKS, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [json.loads((root / f"rank{r}.json").read_text())
                for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for o in outs:
        log(f"[dp shared card] rank {o['rank']}: {json.dumps(o)}")
    a = outs[0]
    depth = preset.model.depth
    bad = []
    for o in outs:
        if (o["card"], o["backend"], o["mesh"]) != (0, "gloo", [DP_RANKS, 1]):
            bad.append(f"rank {o['rank']} on card {o['card']} over "
                       f"{o['backend']}")
        for kind in ("plain", "zero"):
            if o[kind]["losses"] != a["plain"]["losses"]:
                bad.append(f"rank {o['rank']} {kind} losses differ")
            if o[kind]["launches"] != [2 * depth * DP_STEPS,
                                       depth * DP_STEPS]:
                bad.append(f"rank {o['rank']} {kind} B10 launches "
                           f"{o[kind]['launches']}")
        if not (o["zero_bit_equal"] and o["ranks_bit_equal"]):
            bad.append(f"rank {o['rank']}: ZeRO-1 or the ranks not bit-equal")
        s = o["serve"]
        if not s["finite"] or s["shape"] != [LATENT_FRAMES,
                                             cfg.input_channels] or (
                not s["bit_equal"] and (s["max_abs"] > DP_SERVE_ATOL or
                                        s["rel_l2"] > DP_SERVE_REL_L2)):
            bad.append(f"rank {o['rank']} serve {s}")
    for got, want in zip(a["plain"]["losses"], losses):
        if abs(got - want) > 2e-4 * abs(want):
            bad.append(f"loss {got} against the single card's {want}")
    for got, want in zip(a["plain"]["grad_norms"], norms):
        if abs(got - want) > 1e-3 * abs(want):
            bad.append(f"grad norm {got} against the single card's {want}")
    p = a["vs_single"]
    p_max, p_mean = p["max"] / lr_sum, p["worst_mean"] / lr_sum
    if (p_max > DP_PARAM_BOUNDS["p_max"]
            or p_mean > DP_PARAM_BOUNDS["p_mean"]):
        bad.append(f"parameters {p_max} lr max, {p_mean} lr mean")
    log(f"[dp shared card] {card}: 2 ranks on card 0 over gloo, spawned and "
        f"joined in {wall:.1f} s; (a) losses {a['plain']['losses']} against "
        f"{losses} (single card), grad norms {a['plain']['grad_norms']} "
        f"against {norms}, parameters max {p_max:.4f} lr, worst mean "
        f"{p_mean:.5f} lr (summed lr {lr_sum:.3g}; worst leaves "
        f"{p['worst_leaves']}, {p['share_past_lr']:.3g} of the elements past "
        f"1 lr); step ms a rank "
        f"{a['plain']['ms']} against {[round(t, 1) for t in times]}; (b) "
        f"ZeRO-1 bit-equal {a['zero_bit_equal']}, moment elements a rank "
        f"{a['zero']['moment_elements']} against {a['plain']['moment_elements']},"
        f" step ms {a['zero']['ms']}; (c) serve {a['serve']} in "
        f"{a['serve_ms']:.1f} ms")
    if bad:
        raise AssertionError("[dp shared card]: " + "; ".join(bad))


# [tp shared card]: the int8 DiT tensor-parallel on a (1, TP_M) mesh, its
# TP_M ranks spawned on card 0 over gloo (a rank each, sharing the card;
# the collectives go through host memory, so the times say nothing of
# NVLink).  Each rank loads the main path's int8_static tree (saved by the
# parent) and keeps its leaves.  (a) B1's, B5's and B4's split entries at
# the v3 shapes on each rank's share of seeded inputs: the shares joined
# bit-equal to the whole-width kernel on one card.  (b) The main path's
# forward (B3, B2, B4 split, B1 split a block; B5 for the patch embed) on
# a given AdaLN table, [6, 1378, 1024]: bit-equal to the single card's.
# (c) The main path's sampler over the 3790-frame latent (three chunks) at
# TP_STEPS Euler steps: within the JAX package's own tensor-parallel bounds
# of the single-card pass (atol 2e-2, relative L2 5e-2,
# tests/test_trainer_and_infer.py), the max abs difference reported.  (d)
# One forward of --no-fused-prologue (B2, B5 split a block, w8a8_dot's
# torch ops split for out_proj), held as (b).  (e) Each rank's launches of
# (b) and (d).  (f) Each rank's forward ms and peak memory beside the
# single card's.  (g) B14's split entry (out_proj [2112, 640] x [640, 1280]
# and the unfused mlp_out [2112, 2560] x [2560, 1280] a rank), B12's (a
# rank's qkv [6, 352, 896] and rows [640, 1280] of wo) and B13's (MLP 5120:
# two whole slabs a rank; MLP 1280: the one slab shared) on each rank's
# share: each rank's output bit-equal to the whole kernel on one card.  (h)
# One forward of each branch of TP_BRANCHES (the table of its preset; the
# v1legacy preset's own) bit-equal to the single card's, where every split
# is exact; the einsum branch (int8_cli), a library product on a rank's
# heads, is held bit-equal too, and where cuBLAS rounds it apart, within
# the single card's own bf16 gap from its fp32 forward (reported).  (i)
# Each rank's launches of (h).  (h)'s models are cut to their first
# TP_BRANCH_DEPTH blocks for the phase's time (each block is one more
# instance of the same splits).
TP_STEPS = 2
TP_SERVE_ATOL, TP_SERVE_REL_L2 = 2e-2, 5e-2
TP_TIMED = 3
# The int8 DiT's other serving branches, each on a model axis in (h).
TP_BRANCHES = ("opt_in", "split_flash", "pallas", "pallas2", "int8_cli",
               "split_qkv", "int8_qk", "v1legacy")
TP_BRANCH_DEPTH = 8


def tp_cfgs():
    """The main path's DiT config, its --no-fused-prologue sibling, then
    each of TP_BRANCHES (v1legacy at its own preset), TP_BRANCH_DEPTH
    blocks deep."""
    from jatsr_torch.configs import get_preset

    cut = {"depth": TP_BRANCH_DEPTH}
    return {name: dataclasses.replace(
                get_preset(PRESETS.get(name, "v3")).model,
                **{**SERVING, **PATHS[name],
                   **(cut if name in TP_BRANCHES else {})})
            for name in ("prologue", "no_prologue") + TP_BRANCHES}


def tp_third_inputs(torch):
    """(g)'s inputs at the v3 shapes: B14's rows (an all-zero row, one large
    value, a row below the scale floor) and kernels at out_proj and the
    unfused mlp_out; B12's qkv, tables and out projection; B13's rows and
    its two MLPs (5120 and 1280 wide)."""
    from jatsr_torch.models.dit import rope_cos_sin

    a, wo, wso, _ = dense_inputs(torch, B * NP, H, H, SEED + 51)
    a[3] = 0.0
    a[5, 7] = 3.0e4
    a[7] *= 1e-12
    b14 = {"out_proj": (a, wo, wso),
           "mlp_out": dense_inputs(torch, B * NP, 4 * H, H, SEED + 52)[:3]}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    qkv = torch.randn((B, NP, 1792), generator=gen, device="cuda").bfloat16()
    cos, sin = rope_cos_sin(NP, 64, device="cuda")
    b12 = (qkv, cos, sin) + dense_inputs(torch, 1, H, H, SEED + 54)[1:]
    b13 = {}
    for N1 in (4 * H, H):
        a, w1q, w1s, b1 = dense_inputs(torch, B * NP, H, N1, SEED + 55)
        b13[N1] = (a, w1q, w1s, b1) + dense_inputs(torch, 1, N1, H,
                                                   SEED + 56)[1:]
    return b14, b12, b13


def tp_split_inputs(torch):
    """(a)'s inputs at the v3 shapes: B1's x, AdaLN row and mlp_in; B5's
    rows; B4's rows (an all-zero row, one large value) and out_proj."""
    x, _, (sc, sh), w1, ws1, b1 = prologue_inputs(torch, 5120, SEED + 31)
    a5 = dense_inputs(torch, B * N_VALID, H, 5120, SEED + 32)
    a4, wo, wso, _ = dense_inputs(torch, B * NP, H, H, SEED + 33)
    a4[3] = 0.0
    a4[5, 7] = 3.0e4
    return (x, sc, sh, w1, ws1, b1), a5, (a4, wo, wso)


def tp_splits(torch, group, r):
    """(a) on rank ``r``'s share (its columns of mlp_in, its columns of
    out_proj's input and rows of its kernel): CPU copies."""
    from jatsr_torch.ops import split as sp

    (x, sc, sh, w1, ws1, b1), (a, w5, ws5, b5), (a4, wo, wso) = \
        tp_split_inputs(torch)

    def cols(t):
        n = t.shape[-1] // TP_M
        return t[..., r * n:(r + 1) * n].contiguous()

    def rows(t):
        n = t.shape[0] // TP_M
        return t[r * n:(r + 1) * n].contiguous()

    w1r, w5r, wor = cols(w1), cols(w5), rows(wo)
    out = {"b1": sp.int8_norm_mod_dense_gelu_quant_split(
               x, sc, sh, w1r, cols(ws1), cols(b1), group, norm="layer",
               w_t=w1r.t().contiguous()),
           "b5": sp.int8_dense_gelu_quant_split(
               a, w5r, cols(ws5), cols(b5), group, w_t=w5r.t().contiguous()),
           "b4": sp.int8_matmul_fused_split(cols(a4), wor, wso, group,
                                            w_t=wor.t().contiguous())}
    # (g): B14, B12 and B13 on the rank's share.
    from types import SimpleNamespace

    from jatsr_torch.ops.attention import flash_out_weight_t
    from jatsr_torch.parallel.mesh import qkv_columns

    b14, (qkv, cos, sin, wo, wso, bo), b13 = tp_third_inputs(torch)
    for what, (a, w, ws) in b14.items():
        wr = rows(w)
        out[f"b14_{what}"] = sp.int8_matmul_split(
            cols(a), wr, ws, group, w_t=wr.t().contiguous())
    heads = SimpleNamespace(num_q_heads=20, num_kv_heads=4, head_dim=64)
    wr = rows(wo)
    cols12 = qkv_columns(heads, TP_M, r).cuda()
    out["b12"] = sp.gqa_attention_flash_out_split(
        qkv[..., cols12].contiguous(), cos, sin, wr, wso, bo, 20 // TP_M,
        4 // TP_M, group, n_valid=N_VALID,
        wo_t=flash_out_weight_t(wr, 20 // TP_M, 64))
    for N1, (a, w1q, w1s, b1, w2q, w2s, b2) in b13.items():
        w1r, w2r = cols(w1q), rows(w2q)
        out[f"b13_{N1}"] = sp.int8_mlp_split(
            a, w1r, cols(w1s), cols(b1), w2r, w2s, b2, group, rank=r,
            ranks=TP_M, w1_t=w1r.t().contiguous(), w2_t=w2r.t().contiguous())
    torch.cuda.synchronize()
    return {k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
            for k, v in out.items()}


def tp_forward_inputs(torch, C):
    """``x_t``, ``x_cond`` [6, 1378, C] and ``t`` [6] on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
    x_t, x_c = (torch.randn((B, SHORT_FRAMES, C), generator=gen,
                            device="cuda") for _ in range(2))
    return x_t, torch.linspace(0.1, 0.9, B, device="cuda"), x_c


def tp_forwards(torch, model, table, counters, timed=TP_TIMED):
    """One counted forward on the given table, then ``timed`` timed ones:
    the output, the counts, the median ms (``timed`` 0: the counted
    forward's) and the peak GiB."""
    x_t, t, x_c = tp_forward_inputs(torch, model.cfg.input_channels)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = model(x_t, t, x_c, adaln_mod=table)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items()}
    times = [] if timed else [(time.perf_counter() - t0) * 1e3]
    for _ in range(timed):
        t0 = time.perf_counter()
        model(x_t, t, x_c, adaln_mod=table)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (got, counts, sorted(times)[len(times) // 2],
            torch.cuda.max_memory_allocated() / 2.0 ** 30)


def tp_counters():
    from jatsr_torch.ops import split as sp
    from jatsr_torch.ops.attention import (_v_codes, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_flash_out,
                                           gqa_attention_flash_qkv,
                                           gqa_attention_grouped)
    from jatsr_torch.ops.int8_matmul import (int8_dense_gelu_quant,
                                             int8_matmul, int8_matmul_fused,
                                             int8_mlp, int8_quantize_rows)
    from jatsr_torch.ops.prologue import (int8_norm_mod_dense_gelu_quant,
                                          int8_norm_mod_dot)

    return {"norm_mod_dot": int8_norm_mod_dot,
            "flash_qkv": gqa_attention_flash_qkv,
            "matmul_fused": int8_matmul_fused,
            "norm_mod_dense_gelu_quant": int8_norm_mod_dense_gelu_quant,
            "dense_gelu_quant": int8_dense_gelu_quant,
            "flash_qkv_int8_qk": Count(gqa_attention_flash_qkv,
                                       "int8_qk_launches"),
            "v_codes": _v_codes,
            "flash_split": gqa_attention_flash,
            "gqa_attention": gqa_attention,
            "gqa_attention_grouped": gqa_attention_grouped,
            "flash_out": gqa_attention_flash_out,
            "int8_mlp": int8_mlp,
            "int8_matmul": int8_matmul,
            "prequant_quant": int8_quantize_rows,
            "matmul_fused_split": sp.int8_matmul_fused_split,
            "norm_mod_dense_gelu_quant_split":
                sp.int8_norm_mod_dense_gelu_quant_split,
            "dense_gelu_quant_split": sp.int8_dense_gelu_quant_split,
            "int8_matmul_split": sp.int8_matmul_split,
            "flash_out_split": sp.gqa_attention_flash_out_split,
            "int8_mlp_split": sp.int8_mlp_split}


def tp_launches(depth, branch_depth):
    """(e) and (i): a rank's launches of one forward on each path, the
    counters not named 0: a block each of the main path and
    --no-fused-prologue (``depth`` blocks) and of TP_BRANCHES
    (``branch_depth``); the patch embed's B5 once."""
    d, b, patch = depth, branch_depth, {"dense_gelu_quant": 1}
    split_q = {"dense_gelu_quant_split": b, **patch}
    return {
        "prologue": {"norm_mod_dot": d, "flash_qkv": d,
                     "matmul_fused_split": d,
                     "norm_mod_dense_gelu_quant_split": d, **patch},
        "no_prologue": {"flash_qkv": d, "dense_gelu_quant_split": d,
                        **patch},
        "opt_in": {"int8_matmul": b, "prequant_quant": b,
                   "flash_out_split": b, "int8_mlp_split": b, **patch},
        "split_flash": {"flash_split": b, **split_q},
        "pallas": {"gqa_attention": b, **split_q},
        "pallas2": {"gqa_attention_grouped": b, **split_q},
        "int8_cli": {},
        "split_qkv": {"flash_split": b, "int8_matmul": 3 * b,
                      "prequant_quant": 3 * b, "int8_matmul_split": b,
                      **split_q},
        "int8_qk": {"norm_mod_dot": b, "flash_qkv_int8_qk": b, "v_codes": b,
                    "matmul_fused_split": b,
                    "norm_mod_dense_gelu_quant_split": b, **patch},
        "v1legacy": {"flash_split": b, **split_q}}


def tp_rank(rank, root, weights):
    """One rank of ``[tp shared card]``: (a)-(f) of the comment above, the
    results into ``root/rank<r>.json`` and its outputs into
    ``root/out<r>.pt``."""
    import gc
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from jatsr_torch.models.dit import DiT
    from jatsr_torch.parallel import ModelGroup, init_distributed, make_mesh

    root = Path(root)
    cfgs = tp_cfgs()
    init_distributed(f"file://{root}/store", TP_M, rank, local_rank=rank,
                     backend="gloo", device="cuda")
    mesh = make_mesh(1, TP_M, device="cuda")
    out = {"rank": rank, "card": torch.cuda.current_device(),
           "backend": dist.get_backend(), "mesh": list(mesh.shape)}
    tensors = {"splits": tp_splits(torch, ModelGroup(mesh), rank)}
    trees = json.loads((Path(weights) / "tp_trees.json").read_text())
    counters = tp_counters()
    for name, cfg in cfgs.items():
        static = torch.load(Path(weights) / trees[name], mmap=True,
                            weights_only=True)
        table = torch.load(root / f"table_{PRESETS.get(name, 'v3')}.pt"
                           ).cuda()
        torch.cuda.reset_peak_memory_stats()
        model = DiT(cfg, static, device="cuda", mesh=mesh)
        held = sum(b.nbytes for b in model.buffers()) / 2.0 ** 30
        got, counts, ms, peak = tp_forwards(
            torch, model, table, counters,
            0 if name in TP_BRANCHES else TP_TIMED)
        tensors[name] = got.cpu()
        out[name] = {"launches": counts, "ms": ms, "peak_gib": peak,
                     "model_gib": held}
        if name == "prologue":
            _, latent = dp_serve_inputs(torch)
            pipe = dp_pipeline(model, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tensors["serve"] = pipe.super_resolve_latent_device(
                latent, SEED, TP_STEPS, CFG_SCALE, max_batch=3).cpu()
            out["serve_ms"] = (time.perf_counter() - t0) * 1e3
            del pipe, latent
        del model, static
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(tensors, root / f"out{rank}.pt")
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def save_tp_trees(torch, weights, statics):
    """The int8_static tree of each path of ``[tp shared card]`` (``statics``:
    path -> tree, one tree a layout) into ``weights``, each distinct tree
    once (the main path's as ``static.pt``), and ``tp_trees.json``: path ->
    file, which the ranks read."""
    from jatsr_torch.models.from_jax import tree_to_torch

    files, saved = {}, {}
    for name, tree in statics.items():
        if id(tree) not in saved:
            saved[id(tree)] = ("static.pt" if name == "prologue" else
                               f"static_{name}.pt")
            torch.save(tree_to_torch(tree), weights / saved[id(tree)])
        files[name] = saved[id(tree)]
    (weights / "tp_trees.json").write_text(json.dumps(files))


def tp_shared_card_phase(torch, statics, card, weights):
    """``[tp shared card]``: the single-card references, then the ranks
    (:func:`tp_rank`) on this card, then their results checked.
    ``statics``: path -> int8_static tree, as :func:`save_tp_trees` saved
    them.  Returns rank 0's launches of (b), (d) and (h) for the kernel
    lines."""
    import gc
    import shutil
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    from jatsr_torch.models.dit import DiT, adaln_tables
    from jatsr_torch.ops.attention import (flash_out_weight_t,
                                           gqa_attention_flash_out)
    from jatsr_torch.ops.int8_matmul import (int8_dense_gelu_quant,
                                             int8_matmul_fused, int8_mlp)
    from jatsr_torch.ops.prologue import int8_norm_mod_dense_gelu_quant
    from jatsr_torch.ops.quant import w8a8_dot

    cfgs = tp_cfgs()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        t0 = time.perf_counter()
        # (a)'s and (g)'s whole-width kernels on one card.
        (x, sc, sh, w1, ws1, b1), (a, w5, ws5, b5), (a4, wo, wso) = \
            tp_split_inputs(torch)
        whole = {"b1": int8_norm_mod_dense_gelu_quant(
                     x, sc, sh, w1, ws1, b1, norm="layer",
                     w_t=w1.t().contiguous()),
                 "b5": int8_dense_gelu_quant(a, w5, ws5, b5,
                                             w_t=w5.t().contiguous()),
                 "b4": int8_matmul_fused(a4, wo, wso,
                                         w_t=wo.t().contiguous())}
        del x, sc, sh, w1, ws1, b1, a, w5, ws5, b5, a4, wo, wso
        b14, (qkv, cos, sin, wo, wso, bo), b13 = tp_third_inputs(torch)
        for what, (a, w, ws) in b14.items():
            whole[f"b14_{what}"] = w8a8_dot(a, w, ws, impl="pallas",
                                            w_t=w.t().contiguous())
        whole["b12"] = gqa_attention_flash_out(
            qkv, cos, sin, wo, wso, bo, 20, 4, n_valid=N_VALID,
            wo_t=flash_out_weight_t(wo, 20, 64))
        for N1, (a, w1q, w1s, b1, w2q, w2s, b2) in b13.items():
            whole[f"b13_{N1}"] = int8_mlp(a, w1q, w1s, b1, w2q, w2s, b2,
                                          w1_t=w1q.t().contiguous(),
                                          w2_t=w2q.t().contiguous())
        whole = {k: tuple(t.cpu() for t in v) if isinstance(v, tuple)
                 else v.cpu() for k, v in whole.items()}
        del b14, b13, qkv, cos, sin, wo, wso, bo
        ref, single = {}, {}
        counters = tp_counters()
        tables = {}
        for name, cfg in cfgs.items():
            torch.cuda.reset_peak_memory_stats()
            model = DiT(cfg, statics[name], device="cuda")
            held = sum(b.nbytes for b in model.buffers()) / 2.0 ** 30
            preset = PRESETS.get(name, "v3")
            if preset not in tables:
                _, t, _ = tp_forward_inputs(torch, cfg.input_channels)
                tables[preset] = adaln_tables(model, t)
                torch.save(tables[preset].cpu(), root / f"table_{preset}.pt")
            got, counts, ms, peak = tp_forwards(
                torch, model, tables[preset], counters,
                0 if name in TP_BRANCHES else TP_TIMED)
            ref[name] = got.cpu()
            single[name] = {"launches": {k: n for k, n in counts.items()
                                         if n}, "ms": ms, "peak_gib": peak,
                            "model_gib": held}
            if name == "prologue":
                _, latent = dp_serve_inputs(torch)
                pipe = dp_pipeline(model)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ref["serve"] = pipe.super_resolve_latent_device(
                    latent, SEED, TP_STEPS, CFG_SCALE, max_batch=3).cpu()
                single["serve_ms"] = (time.perf_counter() - t1) * 1e3
                del pipe, latent
            del model
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[tp shared card] single-card references: "
            f"{json.dumps(single)}; {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mp.start_processes(tp_rank, args=(str(root), str(weights)),
                           nprocs=TP_M, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [json.loads((root / f"rank{r}.json").read_text())
                for r in range(TP_M)]
        got = [torch.load(root / f"out{r}.pt") for r in range(TP_M)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for o in outs:
        log(f"[tp shared card] rank {o['rank']}: {json.dumps(o)}")
    bad = []
    # (a) the shares joined, against the whole-width kernels; (g) each
    # rank's output, bit for bit.
    for k in ("b1", "b5"):
        codes = torch.cat([g["splits"][k][0] for g in got], dim=-1)
        if not torch.equal(codes, whole[k][0]) or not all(
                torch.equal(g["splits"][k][1], whole[k][1]) for g in got):
            bad.append(f"(a) {k} split not the whole kernel's bits")
    if not all(torch.equal(g["splits"]["b4"], whole["b4"]) for g in got):
        bad.append("(a) b4 split not the whole kernel's bits")
    for k in ("b14_out_proj", "b14_mlp_out", "b12", f"b13_{4 * H}",
              f"b13_{H}"):
        for r, g in enumerate(got):
            if not torch.equal(g["splits"][k].view(torch.int16),
                               whole[k].view(torch.int16)):
                d = (g["splits"][k].float() - whole[k].float()).abs().max()
                bad.append(f"(g) rank {r} {k} split not the whole kernel's "
                           f"bits (max abs {d.item()})")
    # (b), (d), (h) bit-equal; (c) within the bounds.
    diffs = {}
    for k in ("prologue", "no_prologue", "serve") + TP_BRANCHES:
        for r, g in enumerate(got):
            d = (g[k] - ref[k]).abs()
            rel = ((g[k] - ref[k]).norm() / ref[k].norm()).item()
            diffs[f"{k}/{r}"] = (d.max().item(), rel)
            finite = bool(torch.isfinite(g[k]).all())
            what = {"prologue": "b", "no_prologue": "d"}.get(k, "h")
            if k == "serve":
                if (d.max().item() > TP_SERVE_ATOL
                        or rel > TP_SERVE_REL_L2 or not finite):
                    bad.append(f"(c) rank {r}: max abs {d.max().item()}, "
                               f"rel L2 {rel}")
            elif not finite or not torch.equal(g[k], ref[k]):
                bad.append(f"({what}) rank {r} {k}: max abs "
                           f"{d.max().item()}, finite {finite}")
    # (e), (i) the launches of each forward.
    want = tp_launches(cfgs["prologue"].depth, TP_BRANCH_DEPTH)
    for o in outs:
        if (o["card"], o["backend"], o["mesh"]) != (0, "gloo", [1, TP_M]):
            bad.append(f"rank {o['rank']} on card {o['card']} over "
                       f"{o['backend']}")
        for name, w in want.items():
            full = {k: w.get(k, 0) for k in counters}
            if o[name]["launches"] != full:
                part = "i" if name in TP_BRANCHES else "e"
                bad.append(f"({part}) rank {o['rank']} {name} launches "
                           f"{o[name]['launches']} != {full}")
    log(f"[tp shared card] {card}: {TP_M} ranks on card 0 over gloo, "
        f"spawned and joined in {wall:.1f} s; (a) the split entries' shares "
        f"joined bit-equal to B1, B5 and B4 on one card; (g) B14's, B12's "
        f"and B13's on each rank bit-equal to the whole kernels; (b)-(d), "
        f"(h) max abs, rel L2 against one card {diffs}; (f) forward ms a "
        f"rank {[o['prologue']['ms'] for o in outs]} (main path), "
        f"{[o['no_prologue']['ms'] for o in outs]} (--no-fused-prologue) "
        f"against one card's {single['prologue']['ms']:.1f}, "
        f"{single['no_prologue']['ms']:.1f}; (h) first forward ms a rank "
        f"{ {k: [o[k]['ms'] for o in outs] for k in TP_BRANCHES} } against "
        f"one card's { {k: single[k]['ms'] for k in TP_BRANCHES} }; peak "
        f"GiB a rank {[o['prologue']['peak_gib'] for o in outs]} against "
        f"{single['prologue']['peak_gib']:.3f}; the model's buffers GiB a "
        f"rank {[o['prologue']['model_gib'] for o in outs]} against "
        f"{single['prologue']['model_gib']:.3f}; sampler ms "
        f"{[o['serve_ms'] for o in outs]} against {single['serve_ms']:.1f}")
    if bad:
        raise AssertionError("[tp shared card]: " + "; ".join(bad))
    return {k: sum(outs[0][name]["launches"][k] for name in want)
            for k in counters}


# [tp train shared card]: DenseDiT tensor-parallel on a (1, TP_M) mesh,
# trained and served, its TP_M ranks spawned on card 0 over gloo as [tp
# shared card]'s (the collectives through host memory: the times say
# nothing of NVLink).  Against single-card references the parent computes
# first:
# (a) B10 at a rank's heads (q heads h0 = r Hq / TP_M .., their kv heads),
#     bf16 and fp32, forward (o and the row statistics) and backward (dq,
#     dk, dv), at the v3 training shape (q [28, 345, 1280], k/v [28, 345,
#     256], dropout 0.1) and at D = 256 (4/2 heads, batch 4): each rank's
#     launches bit-equal to those heads of one launch over all heads, and
#     within the plain version's bounds at h0;
# (b) TP_TRAIN_STEPS v3mod2 steps at full width and depth under the MSE loss
#     (the perceptual 1/|rfft| gradient magnifies last bits) on TP_TRAIN_B
#     rows: each step's loss and grad norm within rtol 2e-4 of one card's
#     (JAX's bound on the loss for its (4, 2) mesh); every parameter
#     within 2 lr of one card's after the second step; each rank's peak
#     GiB and step ms beside one card's, its B10 launches.  Step 0 runs at
#     lr 0 under warmup, so step 1's loss checks only the forward: the
#     first moments after step 0, (1 - b1) g, hold the backward, on each
#     leaf within twice the one card's own bf16 gap from its fp32 step
#     (:func:`moment_gaps`).  Two witnesses of one step each: at fp32
#     compute (the same split, f and g; rounding 2^-24) the loss and grad
#     norm within rtol 1e-5, the first moments within TP_MU_F32_REL of
#     each leaf's max; under dynamic int8 (B4's split entry at out_proj
#     and mlp_out, the int32 partial products summed again in backward)
#     the loss and grad norm within rtol 2e-4, each leaf's first moments
#     within relative L2 0.5 (TRAIN_REF_BOUNDS, "train_int8": a moved row
#     maximum moves whole rows of the gradient; a wrong sign reads 2);
# (c) the DenseDiT's forward (B11 on the rank's heads) against one card's,
#     at fp32 compute within relative L2 TP_FWD_F32_REL_L2 (the witness:
#     the same split, f and g, where rounding is 2^-24), and at bf16 within
#     that forward's own bf16 noise: its max abs and relative L2 from the
#     one-card fp32 forward of the same weights.  JAX's bound for its
#     mesh, atol 1e-3 (tests/test_trainer_and_infer.py), holds a model a
#     few steps from its AdaLN-Zero start, whose output is near zero; at
#     random weights and 28 blocks cuBLAS on half the columns and g's sum
#     of two fp32 partials round some elements a bf16 ulp apart, which the
#     blocks carry to ~4e-2 on an H100 (PERF.md), so at bf16 atol 1e-3 is
#     reported, not held;
# (d) the dynamic-int8 DenseDiT's forward (B4, its split entry at out_proj
#     and mlp_out) bit-equal to one card's.
# (c) and (d) run on [TP_FWD_B, 1378, 1024] on a given AdaLN table, as [tp
# shared card]'s (b) does.  The batch of (b) is cut from the preset's 28 to
# 8: each step all-reduces six [B, 345, 1280] fp32 tensors a block through
# host memory ([tp shared card]'s gloo reads: ~3 ms a MB), about 7 s a
# step at 8 rows and 25 s at 28; two ranks' states (~6 GiB each) and
# activations fit the card at either batch.
TP_TRAIN_B = 8
TP_TRAIN_STEPS = 2
TP_FWD_B = 4
TP_LOSS_RTOL = 2e-4
TP_FWD_ATOL = 1e-3    # JAX's, reported beside (c)'s bound
TP_FWD_F32_REL_L2 = 1e-5
# The one-step witnesses of (b): tag (TRAIN_PATHS) -> the rtol of their
# loss and grad norm.
TP_WITNESSES = {"train_fp32": 1e-5, "train_int8": TP_LOSS_RTOL}
TP_MU_F32_REL = 1e-5   # the fp32 step's first moments, of each leaf's max
B10_H0_SHAPES = {"v3": (TRAIN_B, TRAIN_N, 20, 4, 64),
                 "d256": (4, TRAIN_N, 4, 2, 256)}


def b10_h0_inputs(torch, shape, dt, seed_):
    """q, k, v, do of ``shape`` (B, N, hq, hkv, D) on the card in ``dt``."""
    Bq, N, hq, hkv, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed_)
    return [torch.randn((Bq, N, w * D), generator=gen, device="cuda").to(dt)
            for w in (hq, hkv, hkv, hq)]


def b10_heads(shape, r):
    """Rank ``r``'s q columns, kv columns and h0."""
    _, _, hq, hkv, D = shape
    qd, kd = hq // TP_M * D, hkv // TP_M * D
    return slice(r * qd, (r + 1) * qd), slice(r * kd, (r + 1) * kd), \
        r * hq // TP_M


def b10_h0_runs(torch, r=None):
    """(a): for each shape and dtype, B10 forward and backward on all heads
    (``r`` None) or on rank ``r``'s at its h0: CPU copies of o, stats, dq,
    dk, dv; on a rank also each output's max abs error against the plain
    version at h0."""
    from jatsr_torch.ops import attention_train as at

    rate, seed = 0.1, -123456789
    out, errs = {}, {}
    for name, shape in B10_H0_SHAPES.items():
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            q, k, v, do = b10_h0_inputs(torch, shape, dt, SEED + 61)
            hq, hkv, h0 = shape[2], shape[3], 0
            if r is not None:
                qs, ks, h0 = b10_heads(shape, r)
                q, do = q[..., qs].contiguous(), do[..., qs].contiguous()
                k, v = k[..., ks].contiguous(), v[..., ks].contiguous()
                hq, hkv = hq // TP_M, hkv // TP_M
            o, st = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate,
                                           h0=h0)
            grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv,
                                           rate, st, h0=h0)
            out[f"{name}_{tag}"] = [t.cpu() for t in (o, st, *grads)]
            if r is not None:
                want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv,
                                                    rate, h0=h0)
                ref = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq,
                                                   hkv, rate, h0=h0)
                errs[f"{name}_{tag}"] = [
                    ((a.float() - w.float()).abs().max().item(),
                     w.float().abs().max().item())
                    for a, w in zip((o, *grads), (want, *ref))]
            del q, k, v, do, o, st, grads
            torch.cuda.empty_cache()
    return out, errs


def check_b10_h0_timed(torch):
    """B10 at a rank's half of the heads (v3's 20/4 at M = 2: 10 q heads,
    2 kv heads) at h0 = 10 against h0 = 0 on the same inputs, in turns (0,
    10, 10, 0), beside the plain version and SDPA on those heads: the
    ``attention_train_{fwd,bwd}_h0`` kernel lines (``launches`` set after
    (b)); the fp32 mode's times in each line's ``fp32``."""
    import torch.nn.functional as F

    from jatsr_torch.ops import attention_train as at

    rate, seed = 0.1, -123456789
    shape = B10_H0_SHAPES["v3"]
    Bq, N, hq, hkv, D = shape
    qs, ks, h0 = b10_heads(shape, 1)
    hq, hkv = hq // TP_M, hkv // TP_M
    lines = {}
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, "fp32")):
        q, k, v, do = b10_h0_inputs(torch, shape, dt, SEED + 62)
        q, do = q[..., qs].contiguous(), do[..., qs].contiguous()
        k, v = k[..., ks].contiguous(), v[..., ks].contiguous()
        o, st = at.attention_train_fwd(q, k, v, seed, hq, hkv, rate, h0=h0)
        want = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate,
                                            h0=h0)
        ref = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq, hkv,
                                           rate, h0=h0)
        grads = at.attention_train_bwd(q, k, v, o, do, seed, hq, hkv, rate,
                                       st, h0=h0)
        err_f = (o.float() - want.float()).abs().max().item()
        err_b = max((a.float() - r_.float()).abs().max().item()
                    for a, r_ in zip(grads, ref))
        del want, ref, grads

        def heads(x, h):
            x = x.reshape(Bq, N, h, D).transpose(1, 2)
            return x.repeat_interleave(hq // h, 1).contiguous()

        q4, k4, v4, do4 = heads(q, hq), heads(k, hkv), heads(v, hkv), \
            heads(do, hq)
        fwd = timings(
            lambda q, k, v, *_: at.attention_train_fwd(q, k, v, seed, hq,
                                                       hkv, rate, h0=h0),
            lambda q, k, v, *_: at.attention_train_fwd_plain(
                q, k, v, seed, hq, hkv, rate, h0=h0),
            lambda q, k, v, q4, k4, v4: F.scaled_dot_product_attention(
                q4, k4, v4, dropout_p=rate),
            (q, k, v, q4, k4, v4), big=(0, 1, 2, 3, 4, 5), reps=50,
            plain_reps=3)
        q4g, k4g, v4g = (x.clone().requires_grad_() for x in (q4, k4, v4))
        out4 = F.scaled_dot_product_attention(q4g, k4g, v4g, dropout_p=rate)
        bwd = timings(
            lambda q, k, v, o, do, *_: at.attention_train_bwd(
                q, k, v, o, do, seed, hq, hkv, rate, st, h0=h0),
            lambda q, k, v, o, do, *_: at.attention_train_bwd_plain(
                q, k, v, o, do, seed, hq, hkv, rate, h0=h0),
            lambda *a: torch.autograd.grad(out4, (q4g, k4g, v4g), a[5],
                                           retain_graph=True),
            (q, k, v, o, do, do4), big=(0, 1, 2, 3, 4), reps=30,
            plain_reps=3)
        del out4, q4g, k4g, v4g, q4, k4, v4, do4
        turns = {"fwd": {0: [], h0: []}, "bwd": {0: [], h0: []}}
        for off in (0, h0, h0, 0):
            turns["fwd"][off].append(time_ms(
                lambda *_: at.attention_train_fwd(q, k, v, seed, hq, hkv,
                                                  rate, h0=off), [()], 30))
            turns["bwd"][off].append(time_ms(
                lambda *_: at.attention_train_bwd(q, k, v, o, do, seed, hq,
                                                  hkv, rate, st, h0=off),
                [()], 20))
        pairs = Bq * hq * N * N * D
        peak = PEAK_FP32 if tag else PEAK_BF16
        b_f = bound(nbytes_of(q, k, v, o, st), 4 * pairs, peak)
        b_b = bound(nbytes_of(q, k, v, o, do, st) + nbytes_of(q, k, v),
                    10 * pairs, peak)
        for way, t, b, err in (("fwd", fwd, b_f, err_f),
                               ("bwd", bwd, b_b, err_b)):
            t0, t1 = (sum(turns[way][x]) / 2 for x in (0, h0))
            entry = {"max_abs_err": err, **t, "bound_ms": b[0],
                     "bound_by": b[1], "ms_h0_0": t0, "ms_h0_turns": t1,
                     "turns_ms": turns[way][0][:1] + turns[way][h0]
                     + turns[way][0][1:]}
            name = f"attention_train_{way}_h0"
            if not tag:
                lines[name] = {
                    "name": name, "route": "cuda",
                    "source": "jatsr_torch/ops/csrc/attention_train.cu",
                    "replaces": ("ops/attention_train.py:340 (JAX package, "
                                 "gqa_attention_train; " +
                                 ("_fwd_call :258, pallas_call :266"
                                  if way == "fwd" else
                                  "_attn_train_bwd :300, pallas_call :312")
                                 + "; a rank's heads at h0)"),
                    **entry, "shape": [Bq, N, hq, hkv, D], "h0": h0,
                    "dropout": rate}
            else:
                lines[name]["fp32"] = {
                    "source": "jatsr_torch/ops/csrc/attention_f32.cu"
                    if way == "fwd" else
                    "jatsr_torch/ops/csrc/attention_f32_bwd.cu", **entry}
            log(f"[kernel] {name}{' ' + tag if tag else ''} at h0 {h0}: "
                f"{t1:.5f} ms against {t0:.5f} at h0 0 on the same heads "
                f"({(t1 / t0 - 1) * 100:+.2f} %), max abs {err:.3g}")
        del q, k, v, do, o, st
        torch.cuda.empty_cache()
    return lines


def tp_train_inputs(torch):
    """(b)'s preset, step config, MSE loss, TP_TRAIN_B rows and stats."""
    preset, tcfg, loss, hr, lr, stats = dp_train_inputs(torch)
    tcfg = dataclasses.replace(tcfg, batch_size=TP_TRAIN_B)
    return (preset, tcfg, loss, hr[:TP_TRAIN_B].contiguous(),
            lr[:TP_TRAIN_B].contiguous(), stats)


def tp_fwd_cfgs():
    """(c)'s bf16 DenseDiT (v3mod2 served: dropout off, B11) and its fp32
    compute witness (B11's fp32 mode), and (d)'s dynamic-int8 one (B4 at
    every projection but the t-MLP and AdaLN)."""
    from jatsr_torch.configs import get_preset

    base = dataclasses.replace(get_preset("v3mod2").model, dropout=0.0,
                               drop_path_rate=0.0, attention_impl="flash")
    return {"bf16": base,
            "fp32": dataclasses.replace(base, dtype="float32"),
            "int8": dataclasses.replace(base, matmul_precision="int8",
                                        int8_impl="fused")}


def tp_fwd_inputs(torch):
    """``x_t``, ``t``, ``x_cond`` [TP_FWD_B, 1378, 1024] on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    x_t, x_c = (torch.randn((TP_FWD_B, TRAIN_FRAMES, 1024), generator=gen,
                            device="cuda") for _ in range(2))
    return x_t, torch.linspace(0.2, 0.8, TP_FWD_B, device="cuda"), x_c


def tp_train_run(torch, dense, mesh=None, witness=None):
    """(b) on one card (no mesh) or a rank: each step's loss, grad norm and
    ms, B10's launches, the peak GiB, the final parameters and the first
    moments after step 0 on the host (this rank's leaves, by name) and
    ``1 - b1``.  ``witness``: a TP_WITNESSES tag, one step on that path
    (fp32 compute, or dynamic int8 on B4)."""
    import gc

    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.ops import attention_train as at
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    preset, tcfg, loss, hr, lr, stats = tp_train_inputs(torch)
    cfg = dataclasses.replace(preset.model, **TRAIN_PATHS.get(witness, {}))
    steps = TP_TRAIN_STEPS if witness is None else 1
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(
        DenseDiT(cfg, dense, device="cuda", mesh=mesh), tcfg, 1000,
        (hr, lr), device="cuda", mesh=mesh)
    step = make_train_step(loss, tcfg, Normalizer(*stats), mesh=mesh)
    at.attention_train_fwd.launches = at.attention_train_bwd.launches = 0
    names = [k for k, _ in state.model.named_parameters()]
    losses, norms, times, mu0 = [], [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, hr, lr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if mu0 is None:
            mu0 = {k: t.cpu() for k, t in zip(names, state.opt_state.mu)}
    out = {"losses": losses, "grad_norms": norms, "ms": times,
           "one_minus_b1": 1.0 - state.tx.b1,
           "launches": [at.attention_train_fwd.launches,
                        at.attention_train_bwd.launches],
           "peak_gib": torch.cuda.max_memory_allocated() / 2.0 ** 30,
           "lr_sum": sum(float(state.tx.schedule(i)) for i in range(steps))}
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    split = dict(state.model.split_dims)
    del state, step, hr, lr
    gc.collect()
    torch.cuda.empty_cache()
    return out, params, split, mu0


def moment_gaps(mus, refs, cut, scale):
    """(b)'s first moments after step 0 against one card's (``mus`` and
    ``refs`` by path: "train", then each TP_WITNESSES tag), each leaf's
    worst ``(gap / bound, leaf)``: "train" against twice the one card's own
    bf16 gap from its fp32 step on that leaf (the triangle inequality
    where each side is no further from the exact gradient than one card's
    bf16 step); "train_fp32" against TP_MU_F32_REL of the leaf's max;
    "train_int8" its relative L2 against TRAIN_REF_BOUNDS' (a moved row
    maximum moves whole rows; a wrong sign reads 2); "ulps": the bf16 gaps
    in bf16 ulps of the leaf's max gradient (``scale`` is ``1 - b1``)."""
    gaps = {k: [] for k in ("train", "train_fp32", "train_int8", "ulps")}

    def ratio(d, b):
        return d / b if b > 0 else (0.0 if d == 0 else math.inf)

    for k, m in mus["train"].items():
        want, want32, want8 = (cut(refs[t], k) for t in
                               ("train", "train_fp32", "train_int8"))
        d = (m - want).abs().max().item()
        noise = (want - want32).abs().max().item()
        gaps["train"].append((ratio(d, 2 * noise), k))
        ulp = bf16_ulp(want.abs().max().item() / scale) * scale
        gaps["ulps"].append((ratio(d, ulp), k))
        d32 = (mus["train_fp32"][k] - want32).abs().max().item()
        gaps["train_fp32"].append(
            (ratio(d32, TP_MU_F32_REL * want32.abs().max().item()), k))
        l2 = ratio((mus["train_int8"][k] - want8).norm().item(),
                   want8.norm().item())
        gaps["train_int8"].append(
            (l2 / TRAIN_REF_BOUNDS["train_int8"]["mu_l2"], k))
    return {key: worst_leaf(v) for key, v in gaps.items()}


def tp_fwd_run(torch, dense, table, mesh=None):
    """(c) and (d): each model's forward on the given AdaLN table (in the
    model's compute dtype), with its ms (one counted call, then TP_TIMED;
    the fp32 witness untimed)."""
    import gc

    from jatsr_torch.models.dit import DenseDiT

    x_t, t, x_c = tp_fwd_inputs(torch)
    outs, ms = {}, {}
    for name, cfg in tp_fwd_cfgs().items():
        model = DenseDiT(cfg, dense, device="cuda", mesh=mesh)
        mod = table.float() if name == "fp32" else table
        with torch.no_grad():
            outs[name] = model(x_t, t, x_c, adaln_mod=mod).cpu()
            times = []
            for _ in range(0 if name == "fp32" else TP_TIMED):
                t0 = time.perf_counter()
                model(x_t, t, x_c, adaln_mod=mod)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        if times:
            ms[name] = sorted(times)[len(times) // 2]
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return outs, ms


def worst_leaf(pairs):
    """The ``(value, leaf)`` of ``pairs`` whose value is largest, a NaN
    counted as infinite (so that it fails every bound)."""
    return max(((math.inf if v != v else v, k) for v, k in pairs),
               default=(0.0, ""))


def bf16_ulp(m: float) -> float:
    """The spacing of bf16 values at ``m`` (> 0): 2^(floor(log2 m) - 7)."""
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def tp_train_rank(rank, root, weights):
    """One rank of ``[tp train shared card]``: (a)-(d) of the comment above,
    the results into ``root/rank<r>.json`` and ``root/out<r>.pt``."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from jatsr_torch.parallel import init_distributed, make_mesh

    root = Path(root)
    init_distributed(f"file://{root}/store", TP_M, rank, local_rank=rank,
                     backend="gloo", device="cuda")
    mesh = make_mesh(1, TP_M, device="cuda")
    out = {"rank": rank, "card": torch.cuda.current_device(),
           "backend": dist.get_backend(), "mesh": list(mesh.shape)}
    b10, out["b10_err"] = b10_h0_runs(torch, rank)
    dense = torch.load(Path(weights) / "dense.pt", mmap=True,
                       weights_only=True)
    out["train"], params, split, mu0 = tp_train_run(torch, dense, mesh)
    mus = {"train": mu0}
    for tag in TP_WITNESSES:
        out[tag], _, _, mus[tag] = tp_train_run(torch, dense, mesh, tag)

    def cut(ref, k):
        return ref[k].chunk(TP_M, split[k])[rank] if k in split else ref[k]

    ref = torch.load(root / "ref_params.pt", mmap=True, weights_only=True)
    out["param_max_diff"] = worst_leaf(
        ((p - cut(ref, k).to(p.device)).abs().max().item(), k)
        for k, p in params.items())
    del params, ref
    refs = {t: torch.load(root / f"ref_mu_{t}.pt", mmap=True,
                          weights_only=True) for t in mus}
    out["mu_gaps"] = moment_gaps(mus, refs, cut,
                                 out["train"]["one_minus_b1"])
    del mu0, mus, refs
    table = torch.load(root / "table.pt").cuda()
    fwd, out["fwd_ms"] = tp_fwd_run(torch, dense, table, mesh)
    torch.save({"b10": b10, "fwd": fwd}, root / f"out{rank}.pt")
    (root / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def tp_train_shared_card_phase(torch, dense, card, weights):
    """``[tp train shared card]``: the single-card references, then the
    ranks (:func:`tp_train_rank`) on this card, then their results checked.
    Returns the h0 kernel lines with rank 0's launches of (b)."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch.multiprocessing as mp

    from jatsr_torch.models.dit import DenseDiT, adaln_tables

    lines = check_b10_h0_timed(torch)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tptrain_"))
    try:
        t0 = time.perf_counter()
        whole, _ = b10_h0_runs(torch)
        os.sync()  # the earlier phases' deleted files, freed on the disk
        single, params, _, mu0 = tp_train_run(torch, dense)
        torch.save({k: p.cpu() for k, p in params.items()},
                   root / "ref_params.pt")
        torch.save(mu0, root / "ref_mu_train.pt")
        del params, mu0
        witness = {}
        for tag in TP_WITNESSES:
            witness[tag], _, _, mu0 = tp_train_run(torch, dense,
                                                   witness=tag)
            torch.save(mu0, root / f"ref_mu_{tag}.pt")
            del mu0
        _, t, _ = tp_fwd_inputs(torch)
        model = DenseDiT(tp_fwd_cfgs()["bf16"], dense, device="cuda")
        with torch.no_grad():
            table = adaln_tables(model, t)
        torch.save(table.cpu(), root / "table.pt")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ref_fwd, single["fwd_ms"] = tp_fwd_run(torch, dense, table)
        # (c)'s bf16 bound: the one card's bf16 forward against its fp32.
        noise = ((ref_fwd["bf16"] - ref_fwd["fp32"]).abs().max().item(),
                 ((ref_fwd["bf16"] - ref_fwd["fp32"]).norm()
                  / ref_fwd["fp32"].norm()).item())
        single["bf16_noise"] = noise
        del table
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[tp train shared card] single-card references: "
            f"{json.dumps(single)}; one step of each witness "
            f"{json.dumps(witness)}; "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mp.start_processes(tp_train_rank, args=(str(root), str(weights)),
                           nprocs=TP_M, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [json.loads((root / f"rank{r}.json").read_text())
                for r in range(TP_M)]
        got = [torch.load(root / f"out{r}.pt") for r in range(TP_M)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for o in outs:
        log(f"[tp train shared card] rank {o['rank']}: {json.dumps(o)}")
    bad = []
    depth = tp_fwd_cfgs()["bf16"].depth
    for r, (o, g) in enumerate(zip(outs, got)):
        if (o["card"], o["backend"], o["mesh"]) != (0, "gloo", [1, TP_M]):
            bad.append(f"rank {r} on card {o['card']} over {o['backend']}")
        # (a) a rank's heads: bit-equal to the whole launch's.
        for key, mine in g["b10"].items():
            shape = B10_H0_SHAPES[key.rsplit("_", 1)[0]]
            qs, ks, _ = b10_heads(shape, r)
            o_w, st_w, dq_w, dk_w, dv_w = whole[key]
            hq = shape[2] // TP_M
            want = [o_w[..., qs], st_w[:, r * hq:(r + 1) * hq],
                    dq_w[..., qs], dk_w[..., ks], dv_w[..., ks]]
            if not all(torch.equal(a, w) for a, w in zip(mine, want)):
                bad.append(f"(a) rank {r} {key}: not the whole launch's "
                           f"heads")
            for (e, m), name in zip(o["b10_err"][key],
                                    ("o", "dq", "dk", "dv")):
                # The bounds of check_attention_train and the fp32 mode's.
                lim = (REL_F32_TRAIN * m if key.endswith("fp32") else
                       2e-2 + 2e-2 * m if name == "o" else REL_ATTN_BWD * m)
                if not e <= lim:
                    bad.append(f"(a) rank {r} {key} {name}: max abs {e} "
                               f"against the plain version at h0 > {lim}")
        # (b) the steps.  Each comparison is written so that NaN fails.
        tr = o["train"]
        for key in ("losses", "grad_norms"):
            for a, w in zip(tr[key], single[key]):
                if not abs(a - w) <= TP_LOSS_RTOL * abs(w):
                    bad.append(f"(b) rank {r} {key} {a} against {w}")
        if tr["launches"] != [2 * depth * TP_TRAIN_STEPS,
                              depth * TP_TRAIN_STEPS]:
            bad.append(f"(b) rank {r} B10 launches {tr['launches']}")
        for tag, rtol in TP_WITNESSES.items():
            for key in ("losses", "grad_norms"):
                for a, w in zip(o[tag][key], witness[tag][key]):
                    if not abs(a - w) <= rtol * abs(w):
                        bad.append(f"(b) rank {r} {tag} {key} {a} against "
                                   f"{w}")
        for key in ("train", *TP_WITNESSES):
            u, leaf = o["mu_gaps"][key]
            if not u <= 1.0:
                bad.append(f"(b) rank {r} {key} {leaf}: first moments after "
                           f"step 0 {u} times the bound from one card's")
        d, leaf = o["param_max_diff"]
        if not d <= 2 * single["lr_sum"] * 1.01:
            bad.append(f"(b) rank {r} {leaf} {d} past 2 lr "
                       f"({single['lr_sum']})")
        # (c), (d) the forwards.
        fwd = {}
        for name in ("bf16", "fp32"):
            diff = g["fwd"][name] - ref_fwd[name]
            fwd[name] = {"max_abs": diff.abs().max().item(),
                         "rel_l2": (diff.norm()
                                    / ref_fwd[name].norm()).item()}
        dc, rel = fwd["bf16"]["max_abs"], fwd["bf16"]["rel_l2"]
        if not (dc <= noise[0] and rel <= noise[1]):
            bad.append(f"(c) rank {r}: max abs {dc}, rel L2 {rel} past the "
                       f"one card's bf16 noise {noise}")
        if not fwd["fp32"]["rel_l2"] <= TP_FWD_F32_REL_L2:
            bad.append(f"(c) rank {r} fp32: {fwd['fp32']} past rel L2 "
                       f"{TP_FWD_F32_REL_L2}")
        if not torch.equal(g["fwd"]["int8"], ref_fwd["int8"]):
            dd = (g["fwd"]["int8"] - ref_fwd["int8"]).abs().max().item()
            bad.append(f"(d) rank {r}: not bit-equal (max abs {dd})")
        o["fwd_bf16"] = {**fwd["bf16"], "within_jax_atol": dc <= TP_FWD_ATOL}
        o["fwd_fp32"] = fwd["fp32"]
    a = outs[0]
    steps = {tag: [[o[tag][k] for k in ("losses", "grad_norms", "ms")]
                   for o in outs] for tag in TP_WITNESSES}
    log(f"[tp train shared card] {card}: {TP_M} ranks on card 0 over gloo, "
        f"spawned and joined in {wall:.1f} s; (a) each rank's heads "
        f"bit-equal to the whole launch's, bf16 and fp32, D 64 and 256; (b) "
        f"losses {a['train']['losses']} against {single['losses']}, grad "
        f"norms {a['train']['grad_norms']} against {single['grad_norms']}, "
        f"first moments after step 0, worst leaf over its bound "
        f"{[o['mu_gaps'] for o in outs]}; the witnesses' steps, losses, "
        f"grad norms and ms a rank {steps} against the single card's "
        f"{witness}; "
        f"parameters max {[o['param_max_diff'] for o in outs]} (lr sum "
        f"{single['lr_sum']:.3g}), step ms a rank "
        f"{[o['train']['ms'] for o in outs]} against {single['ms']}, peak "
        f"GiB a rank {[o['train']['peak_gib'] for o in outs]} against "
        f"{single['peak_gib']:.3f}, B10 launches a rank "
        f"{a['train']['launches']}; (c) fp32 {[o['fwd_fp32'] for o in outs]}"
        f" (bound rel L2 {TP_FWD_F32_REL_L2}), bf16 "
        f"{[o['fwd_bf16'] for o in outs]} "
        f"against the one card's bf16 noise (max abs, rel L2) {noise}; (d) "
        f"int8 bit-equal; "
        f"forward ms a rank {[o['fwd_ms'] for o in outs]} against "
        f"{single['fwd_ms']}")
    if bad:
        raise AssertionError("[tp train shared card]: " + "; ".join(bad))
    fwd_n, bwd_n = a["train"]["launches"]
    lines["attention_train_fwd_h0"]["launches"] = fwd_n
    lines["attention_train_bwd_h0"]["launches"] = bwd_n
    for name in lines:
        lines[name]["launches_a_rank_step"] = \
            lines[name]["launches"] // TP_TRAIN_STEPS
    return lines


# [dp nccl]: the NCCL path users launch, at a world of one:
# ``python -m torch.distributed.run --standalone --nproc_per_node 1`` of
# ``cli.train --distributed --mesh 1 1 --shard-opt-state`` and of
# ``cli.infer --mesh 1 1``.  cli_train_phase holds each against the same
# call without a mesh.
DP_NCCL = ["--distributed", "--mesh", "1", "1", "--shard-opt-state"]


def torchrun(args, cwd):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1
    args`` in ``cwd`` with this checkout on the path; raises with its
    output's end on failure; returns its seconds."""
    import os

    t0 = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args)}: rc "
                             f"{out.returncode}\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-3000:]}")
    return time.perf_counter() - t0


def same_checkpoint(torch, a, b):
    """Tensors of two ``state.pt`` files bit-equal, and their metas equal:
    ``(equal, tensors)``."""
    sa = torch.load(a / "state.pt", weights_only=True)
    sb = torch.load(b / "state.pt", weights_only=True)
    ta, tb = sa["state"], sb["state"]
    pairs = [(ta["params"], tb["params"]), (ta["opt"]["mu"], tb["opt"]["mu"]),
             (ta["opt"]["nu"], tb["opt"]["nu"])]
    n, ok = 0, sa["meta"] == sb["meta"]
    for x, y in pairs:
        ok = ok and x.keys() == y.keys()
        for k in x:
            n += 1
            ok = ok and torch.equal(x[k], y[k])
    return ok and ta["step"] == tb["step"], n


def main() -> int:
    import argparse
    import shutil
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one more sampler call of each serving path, "
                         "one more decode of each kind, one more train "
                         "step, and one more step under each remat policy, "
                         "with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    phases = Phases()

    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.dac import DAC, DACConfig
    from jatsr_torch.models.dit import DenseDiT, DiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops import _build
    from jatsr_torch.ops import dac_kernels as dk
    from jatsr_torch.ops.attention import (_v_codes, gqa_attention,
                                           gqa_attention_flash,
                                           gqa_attention_flash_out,
                                           gqa_attention_flash_qkv,
                                           gqa_attention_grouped)
    from jatsr_torch.ops.int8_matmul import (int8_dense_gelu_quant,
                                             int8_matmul, int8_matmul_fused,
                                             int8_mlp, int8_quantize_rows)
    from jatsr_torch.ops.prologue import (int8_norm_mod_dense_gelu_quant,
                                          int8_norm_mod_dot)
    from jatsr_torch.ops.quant import quantize_params_static
    from jatsr_torch.models.from_jax import tree_to_torch
    from jatsr_torch.utils.device import resolve_device

    # 1. Environment.
    card = card_line()
    resolve_device("cuda")
    log(f"[env] card: {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")

    # 2. Build.
    sources = ("flash_qkv", "dense_gelu_quant", "norm_mod", "w8a8_fused",
               "mlp_full", "dac_res", "snake_tr", "snake_tr_stream",
               "attention_train", "attention_deferred", "attention_natural",
               "attention_wide", "attention_f32", "attention_f32_bwd")
    _build.load("flash_qkv")
    log(f"[build] {_build.build_seconds:.1f} s for all kernels")
    for name in sources:
        for kernel, regs, spills in build_report(_build.build_log(name)):
            log(f"[build] {name}: {kernel}: {regs} registers, "
                f"{spills or 'no spills'}")
    phases.done("environment and build")

    # 3. Kernels against their plain versions at the paths' shapes.
    cfgs = {k: dataclasses.replace(get_preset(PRESETS.get(k, "v3")).model,
                                   **{**SERVING, **v})
            for k, v in PATHS.items()}
    norm = cfgs["prologue"].norm
    checks = {
        "flash_qkv": check_attention(torch),
        "norm_mod_dot": check_norm_mod_dot(torch, norm),
        "matmul_fused": check_matmul_fused(torch),
        "norm_mod_dense_gelu_quant": check_norm_mod_gelu(torch, norm),
        "flash_out": check_flash_out(torch),
        "int8_mlp": check_int8_mlp(torch),
        "int8_matmul": check_int8_matmul(torch),
        "flash_qkv_int8_qk": check_attention_int8_qk(torch),
        **check_split_attention(torch),
    }
    for name, extra in check_attention_extra(torch).items():
        checks[name].update(extra)
    patch = check_dense_gelu(torch, B * NP, 8192, 512)
    mlp_in = check_dense_gelu(torch, B * N_VALID, 1280, 5120)
    checks["dense_gelu_quant"] = {
        "name": "dense_gelu_quant", "route": "cuda",
        "source": "jatsr_torch/ops/csrc/dense_gelu_quant.cu",
        "replaces": "ops/int8_matmul.py:254 (JAX package, "
                    "int8_dense_gelu_quant; pallas_call :290)",
        **{k: patch[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
        "patch_embed": patch, "mlp_in_no_prologue": mlp_in}
    checks.update(check_fp32_modes(torch, norm, checks))
    checks.update(check_fp32_slice(torch, checks))
    checks.update(check_split_kernels(torch, norm, checks))
    checks.update(check_dac_kernels(torch))
    checks.update(check_dac_kernels_snake_bf16(torch))
    checks.update(check_attention_train(torch))
    checks.update(check_attention_train_fp32(torch, checks))
    check_attention_train_offset(torch, checks)
    torch.cuda.empty_cache()
    for name, c in checks.items():
        log(f"[kernel] {name} {json.dumps(c)}")
    phases.done("kernels against their plain versions")

    # 4. The eighteen serving paths at full width, on one set of dense
    #    weights for each preset (quantized for each int8_static layout)
    #    and one for each decode (fused, unfused).
    t0 = time.perf_counter()
    dense = random_dense_params(cfgs["prologue"], SEED)
    denses = {"v3": dense,
              "v1legacy": random_dense_params(cfgs["v1legacy"], SEED)}
    statics = {}

    def static_of(name):
        """The int8_static tree of path ``name``'s layout (q/k/v fused or
        apart, the head quantized or not), quantized once."""
        cfg = cfgs[name]
        key = (PRESETS.get(name, "v3"), cfg.fused_qkv, cfg.quantize_head)
        if key not in statics:
            statics[key] = quantize_params_static(denses[key[0]], cfg)
        return statics[key]

    def build(name, device):
        cfg = cfgs[name]
        if cfg.matmul_precision in ("int8", "bf16"):
            return DenseDiT(cfg, denses[PRESETS.get(name, "v3")],
                            device=device)
        return DiT(cfg, static_of(name), device=device)

    static_of("prologue")
    log(f"[model] v3 int8_static weights: {time.perf_counter() - t0:.1f} s "
        f"to draw and quantize")
    codecs = {f: DAC.random_init(SEED, DACConfig(), fused_res_units=f,
                                 device="cuda") for f in (True, False)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.randn((LATENT_FRAMES, cfgs["prologue"].input_channels),
                     generator=gen, device="cuda")
    counters = {"flash_qkv": gqa_attention_flash_qkv,
                "dense_gelu_quant": int8_dense_gelu_quant,
                "norm_mod_dot": int8_norm_mod_dot,
                "matmul_fused": int8_matmul_fused,
                "norm_mod_dense_gelu_quant": int8_norm_mod_dense_gelu_quant,
                "snake_conv_transpose_streamed":
                    dk.snake_conv_transpose_streamed,
                "snake_conv_transpose_fused": dk.snake_conv_transpose_fused,
                "res_stage_fused": dk.res_stage_fused,
                "res_unit_fused": dk.res_unit_fused,
                "flash_out": gqa_attention_flash_out,
                "int8_mlp": int8_mlp,
                "int8_matmul": int8_matmul,
                "flash_split": gqa_attention_flash,
                "gqa_attention": gqa_attention,
                "gqa_attention_grouped": gqa_attention_grouped,
                "flash_qkv_int8_qk": Count(gqa_attention_flash_qkv,
                                           "int8_qk_launches"),
                **{f"{k}_fp32": Count(fn, "f32_launches") for k, fn in (
                    ("flash_qkv", gqa_attention_flash_qkv),
                    ("norm_mod_dot", int8_norm_mod_dot),
                    ("matmul_fused", int8_matmul_fused),
                    ("norm_mod_dense_gelu_quant",
                     int8_norm_mod_dense_gelu_quant),
                    ("dense_gelu_quant", int8_dense_gelu_quant),
                    ("flash_out", gqa_attention_flash_out),
                    ("int8_mlp", int8_mlp),
                    ("flash_split", gqa_attention_flash),
                    ("gqa_attention", gqa_attention),
                    ("gqa_attention_grouped", gqa_attention_grouped))},
                "flash_qkv_int8_qk_fp32": Count(gqa_attention_flash_qkv,
                                                "int8_qk_f32_launches"),
                **{f"{k}_snake_bf16": Count(getattr(dk, k), "b16_launches")
                   for k in ("snake_conv_transpose_streamed",
                             "snake_conv_transpose_fused", "res_stage_fused",
                             "res_unit_fused")},
                "prequant_quant": int8_quantize_rows,
                "v_codes": _v_codes,
                **{k: v for k, v in tp_counters().items()
                   if k.endswith("_split")}}
    per_block = STEPS * cfgs["prologue"].depth
    segments = 2  # 3790 frames: two decode segments, one per decode call
    fused_decode = {"snake_conv_transpose_streamed": segments,
                    "snake_conv_transpose_fused": 3 * segments,
                    "res_stage_fused": 3 * segments, "res_unit_fused": 0}
    none = {k: 0 for k in counters}
    expected = {
        "prologue": {**none, "flash_qkv": per_block,
                     "dense_gelu_quant": STEPS, "norm_mod_dot": per_block,
                     "matmul_fused": per_block,
                     "norm_mod_dense_gelu_quant": per_block, **fused_decode},
        "no_prologue": {**none, "flash_qkv": per_block,
                        "dense_gelu_quant": per_block + STEPS},
        "opt_in": {**none, "dense_gelu_quant": STEPS, "flash_out": per_block,
                   "int8_mlp": per_block, "int8_matmul": per_block,
                   "prequant_quant": per_block, **fused_decode},
    }
    for name, kernel in (("split_flash", "flash_split"),
                         ("pallas", "gqa_attention"),
                         ("pallas2", "gqa_attention_grouped")):
        expected[name] = {**none, kernel: per_block,
                          "dense_gelu_quant": per_block + STEPS,
                          **fused_decode}
    # --int8 --quantize-head: no kernel in the DiT (the einsum attention,
    # the QuantDense products by torch._int_mm); q/k/v apart: B11, B5 for
    # the patch embed and every mlp_in, and B14 behind its row quant for
    # each of q, k, v and out_proj; int8_qk: the main path's counts, but
    # B2 each time with its s8 value product behind its codes launch, and
    # every DAC launch in bf16-snake mode; v1legacy (12 blocks): B11 and B5;
    # dynamic int8: B11, and B4 for the patch embed's two products and the
    # six of every block.
    per_block_v1 = STEPS * cfgs["v1legacy"].depth
    expected.update({
        "int8_cli": {**none, **fused_decode},
        "split_qkv": {**none, "flash_split": per_block,
                      "dense_gelu_quant": per_block + STEPS,
                      "int8_matmul": 4 * per_block,
                      "prequant_quant": 4 * per_block, **fused_decode},
        "int8_qk": {**expected["prologue"], "flash_qkv": 0,
                    "flash_qkv_int8_qk": per_block, "v_codes": per_block,
                    **{f"{k}_snake_bf16": n for k, n in fused_decode.items()}},
        "v1legacy": {**none, "flash_split": per_block_v1,
                     "dense_gelu_quant": per_block_v1 + STEPS,
                     **fused_decode},
        "dynamic": {**none, "flash_split": per_block,
                    "matmul_fused": STEPS * (2 + 6 * cfgs["dynamic"].depth),
                    **fused_decode},
        # --bf16: B11 a block (the products are torch.matmul's); fp32: the
        # main path's launches, every one of B2-B5's in its fp32 mode (a
        # wrapper's launches count both modes, its f32_launches the fp32
        # one).
        "bf16": {**none, "flash_split": per_block, **fused_decode}})

    def at_fp32(counts, no_quant=False):
        """A path's counts at dtype="float32": each launch of a kernel
        with an fp32 mode is in that mode too (a wrapper's launches count
        both modes); ``no_quant``: w8a8_dot quantises an fp32 lhs with
        torch ops (the JAX package's XLA), not the row-quant launch."""
        out = {**counts, **{f"{k}_fp32": n for k, n in counts.items()
                            if f"{k}_fp32" in counters}}
        return {**out, "prequant_quant": 0} if no_quant else out

    # The short paths: one chunk, SHORT_STEPS forwards, no decode.
    per_short = SHORT_STEPS * cfgs["prologue"].depth
    short = {"dense_gelu_quant": SHORT_STEPS}
    expected.update({
        "fp32": at_fp32(expected["prologue"]),
        "fp32_third": at_fp32(expected["opt_in"], no_quant=True),
        "fp32_split": at_fp32(expected["split_flash"]),
        "fp32_pallas": at_fp32({**none, "gqa_attention": per_short,
                                "dense_gelu_quant": per_short + SHORT_STEPS}),
        "fp32_pallas2": at_fp32({**none, "gqa_attention_grouped": per_short,
                                 "dense_gelu_quant":
                                     per_short + SHORT_STEPS}),
        "fp32_int8_qk": at_fp32({**none, **short,
                                 **{k: per_short for k in (
                                     "norm_mod_dot", "matmul_fused",
                                     "norm_mod_dense_gelu_quant",
                                     "flash_qkv_int8_qk", "v_codes")}})})
    models, fns, launches = {}, {}, {}
    for name, cfg in cfgs.items():
        models[name] = build(name, "cuda")
        if name in SHORT:
            continue
        fns[name] = make_server(torch, models[name],
                                codecs[FUSED_DECODE[name]], lr,
                                SNAKE.get(name, "float32"))
        fns[name][2]()  # warm-up: cuDNN algorithm choice, allocator
    phases.done("weights, codecs and warm-up passes")
    # Each path's counted pass; the kernel line takes a kernel's launches
    # from the main path, or from the path KERNEL_PATH names.
    latents = {}
    for name in fns:
        launches[name], latents[name] = counted_pass(
            torch, name, fns[name][2], counters, expected[name],
            cfgs[name].input_channels)
    for name in SHORT:
        launches[name] = short_pass(torch, name, models[name], lr, counters,
                                    expected[name])
    phases.done("counted passes")
    # Audio in, audio out: the main path's DiT behind super_resolve_audio,
    # with the fused codec's encoder; timed in the same turns.
    launches["audio"], audio_serve = audio_phase(
        torch, models["prologue"], codecs[True], counters,
        expected["prologue"], card)
    phases.done("audio in, audio out")
    timed_passes({**{name: f[2] for name, f in fns.items()},
                  "audio": audio_serve}, card)
    phases.done("timed passes")
    if args.profile:
        for name, (sample, _, _) in fns.items():
            profile_phase(torch, f"{name} sampler", sample)
        for name in ("prologue", "no_prologue"):  # one of each decode
            profile_phase(torch, f"{name} decode "
                          f"({'fused' if FUSED_DECODE[name] else 'unfused'})",
                          lambda: fns[name][1](latents[name]))
        phases.done("profiles")
    check_decode(torch, codecs[True], codecs[False],
                 latents["prologue"][:DECODE_L][None])
    check_audio_references(torch, codecs[True])
    del codecs, fns, latents, audio_serve
    phases.done("decode and audio references")

    # 5. Reference on a small input: each full-width DiT on the card
    #    (kernels) and on the CPU (plain versions).  100 frames are 25
    #    patches: aligned to 32 (keys masked past 25) where align_n is
    #    taken, padded to 32 inside flash_split.
    for name, cfg in cfgs.items():
        if name in SHORT:
            continue
        cpu_model = build(name, "cpu")
        check_reference(torch, name, models[name], cpu_model,
                        100 if cfg.align_n else 64)
        if name == "prologue":
            check_heun(torch, models[name], cpu_model)
        del cpu_model

    main_static = static_of("prologue")  # for [dp shared card]
    # [tp shared card]'s trees, quantized above (one a layout; (h)'s cut
    # to TP_BRANCH_DEPTH blocks, copies).
    cut = {}
    tp_statics = {name: static_of(name) for name in ("prologue",
                                                     "no_prologue")}
    for name in TP_BRANCHES:
        tree = static_of(name)
        if id(tree) not in cut:
            cut[id(tree)] = {**tree, "blocks": _cut_blocks(
                tree["blocks"], TP_BRANCH_DEPTH, copy=True)}
        tp_statics[name] = cut[id(tree)]
    del models, statics, denses
    torch.cuda.empty_cache()
    phases.done("DiT references")

    # 6. The training paths: the v3mod2 train step at full width (the same
    #    dense weights) as its preset trains it, at fp32 and with bf16
    #    parameters, then one step of each at batch 4 against the CPU.
    launches["train"] = train_phase(torch, dense, args.profile)
    torch.cuda.empty_cache()
    for tag in ("train_fp32", "train_bf16_params", "train_int8"):
        launches[tag] = train_phase(torch, dense, args.profile, tag,
                                    timed=TRAIN_TIMED_DTYPES)
        torch.cuda.empty_cache()
    phases.done("training")
    for tag in TRAIN_PATHS:
        check_train_reference(torch, dense, tag)
    check_tiny_train_step(torch)
    phases.done("training references")

    # The dense weights and the main path's int8 tree, written once for the
    # processes of phases 7 and 8 (the machine's disk takes 45 GiB of
    # writes in all; the training entry point's checkpoints are most).
    weights = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_"))
    try:
        t0 = time.perf_counter()
        torch.save(tree_to_torch(dense), weights / "dense.pt")
        save_tp_trees(torch, weights, tp_statics)
        log(f"[weights] dense and int8 trees saved for the subprocesses: "
            f"{time.perf_counter() - t0:.1f} s")

        # 7. The training entry point at full width (train, checkpoint,
        #    resume, serve a run), then two steps under each remat policy.
        _, nccl = cli_train_phase(torch, card, weights / "dense.pt")
        phases.done("training entry point and [dp nccl] ("
                    f"{sum(nccl.values()):.1f} s of torchrun calls)")
        remat_phase(torch, dense, card, args.profile)
        torch.cuda.empty_cache()
        phases.done("remat policies")

        # 8. Data-parallel training and serving over two ranks on this
        #    card, then the int8 DiT tensor-parallel over two ranks on it.
        dp_shared_card_phase(torch, dense, main_static, card, weights)
        torch.cuda.empty_cache()
        phases.done("[dp shared card]")
        launches["tp"] = tp_shared_card_phase(torch, tp_statics, card,
                                              weights)
        torch.cuda.empty_cache()
        phases.done("[tp shared card]")
        h0_lines = tp_train_shared_card_phase(torch, dense, card, weights)
        del dense, main_static, tp_statics
        torch.cuda.empty_cache()
        phases.done("[tp train shared card]")
    finally:
        shutil.rmtree(weights, ignore_errors=True)

    # 9. Data in: python -m jatsr_torch.cli.prepare_dataset on a corpus at
    #    the codec's full width, resumed; the prefetch overlap; card vs CPU.
    prepare_phase(torch, card)
    phases.done("data preparation")

    # Result lines.
    kernels = [dict(checks[k], launches=launches[
        KERNEL_PATH.get(k, "prologue")][k]) for k in counters
        if k not in HELPERS]
    kernels += [dict(checks[k], launches=launches[
        "train_fp32" if k.endswith("_fp32") else "train"][k])
        for k in train_counters()]
    kernels += list(h0_lines.values())
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-from"]:
        sys.exit(train_from_saved(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
