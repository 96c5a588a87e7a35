#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Builds the hand-written kernels from ``jatsr_torch/ops/csrc/``, holds each
against its plain PyTorch version at the serving path's own shapes (and
times kernel, plain version and a PyTorch library call as a yardstick),
then drives the port's serving path once at full width: the v3 766 M int8
DiT (random weights from a seed, quantized by the port) through the Euler
CFG sampler over ~44 s of latent, then the segmented fp32 DAC decode.  It
checks the launch counts of that run, the waveform, and the full-width DiT
on the card against the same DiT's plain path on the CPU at a small input.

With ``--profile`` it also traces one more sampler call and one more
decode with ``torch.profiler`` and prints, for each, the card's busy share
and device time by kernel name.

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
import subprocess
import sys
import time

SEED = 0
STEPS, CFG_SCALE = 8, 3.0
LATENT_FRAMES = 3790          # ~44 s: three 16 s chunks with 2 s crossfades
SEGMENT_FRAMES, CTX_FRAMES = 2756, 64
TIMED_RUNS = 4                # serving passes timed; the first is counted
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16 = 989e12            # dense tensor-core FLOP/s
PEAK_INT8 = 1979e12           # dense tensor-core OP/s


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, reps):
    """Mean ms per call on the card (CUDA events), after a warm-up; calls
    rotate over ``arg_sets`` so that inputs do not stay in L2."""
    import torch

    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rotations(nbytes: int) -> int:
    """Copies of one input set that together exceed the 50 MB L2."""
    return max(2, min(32, math.ceil(96e6 / nbytes)))


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_attention(torch):
    """flash_qkv against its plain version at qkv [6, 345, 1792] bf16."""
    import torch.nn.functional as F

    from jatsr_torch.models.dit import rope_cos_sin
    from jatsr_torch.ops.attention import (_rope, flash_qkv_plain,
                                           gqa_attention_flash_qkv)

    B, N, hq, hkv, D = 6, 345, 20, 4, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qkv = torch.randn((B, N, (hq + 2 * hkv) * D), generator=gen,
                      device="cuda").bfloat16()
    cos, sin = rope_cos_sin(N, D, device="cuda")
    got = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv)
    want = flash_qkv_plain(qkv, cos, sin, hq, hkv)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = 2e-2 + 2e-2 * want.float().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"flash_qkv: max err {err.max().item()} "
                             f"outside atol=rtol=2e-2")
    masked = gqa_attention_flash_qkv(qkv, cos, sin, hq, hkv, n_valid=300)
    want_m = flash_qkv_plain(qkv, cos, sin, hq, hkv, n_valid=300)
    torch.testing.assert_close(masked.float(), want_m.float(), atol=2e-2,
                               rtol=2e-2)

    sets = [(qkv.clone(), cos, sin) for _ in range(rotations(qkv.nbytes))]
    ms = time_ms(lambda x, c, s: gqa_attention_flash_qkv(x, c, s, hq, hkv),
                 sets, 200)
    plain_ms = time_ms(lambda x, c, s: flash_qkv_plain(x, c, s, hq, hkv),
                       sets[:4], 20)
    # Yardstick: SDPA on the RoPE'd, head-split q/k/v (kv heads repeated).
    heads = qkv.reshape(B, N, hq + 2 * hkv, D).permute(0, 2, 1, 3)
    cb, sb = cos.bfloat16(), sin.bfloat16()
    q = _rope(heads[:, :hq], cb, sb).contiguous()
    k = _rope(heads[:, hq:hq + hkv], cb, sb).repeat_interleave(hq // hkv, 1)
    v = heads[:, hq + hkv:].repeat_interleave(hq // hkv, 1).contiguous()
    lib_sets = [(q.clone(), k.clone(), v.clone())
                for _ in range(rotations(3 * q.nbytes))]
    lib_ms = time_ms(F.scaled_dot_product_attention, lib_sets, 200)
    nbytes = qkv.nbytes + cos.nbytes + sin.nbytes + got.nbytes
    b_ms, b_by = bound(nbytes, 4 * B * hq * N * N * D, PEAK_BF16)
    return {"name": "flash_qkv", "route": "cuda",
            "source": "jatsr_torch/ops/csrc/flash_qkv.cu",
            "replaces": "ops/attention.py:415 (JAX package, "
                        "gqa_attention_flash_qkv; pallas_call :449)",
            "max_abs_err": err.max().item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": [B, N, (hq + 2 * hkv) * D]}


def check_dense_gelu(torch, M, K, N):
    """dense_gelu_quant against its plain version at one path shape."""
    import torch.nn.functional as F

    from jatsr_torch.ops.int8_matmul import (_INV127, dense_gelu_quant_plain,
                                             int8_dense_gelu_quant, int8_mm,
                                             quantize_rows)

    gen = torch.Generator(device="cuda").manual_seed(SEED + K)
    a = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w_q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_s = torch.rand((1, N), generator=gen, device="cuda") \
        .add_(0.5).div_(127 * K ** 0.5)
    b = 0.1 * torch.randn((1, N), generator=gen, device="cuda")
    got_q, got_s = int8_dense_gelu_quant(a, w_q, w_s, b)
    want_q, want_s = dense_gelu_quant_plain(a, w_q, w_s, b)
    torch.cuda.synchronize()
    diff = (got_q.int() - want_q.int()).abs()
    frac = (diff != 0).float().mean().item()
    if diff.max().item() > 1 or frac > 0.005:
        raise AssertionError(f"dense_gelu_quant {M}x{K}x{N}: codes differ by "
                             f"up to {diff.max().item()} on {frac:.4%}")
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=0)

    def library(a, w_q, w_s, b):
        a_q, s = quantize_rows(a)
        y = int8_mm(a_q, w_q).float() * s.clamp_min(1e-12) * w_s + b
        g = F.gelu(y, approximate="tanh")
        gs = (g.abs().amax(1, keepdim=True) * _INV127).clamp_min(1e-12)
        return torch.round(g / gs).to(torch.int8), gs

    sets = [(a.clone(), w_q.clone(), w_s, b)
            for _ in range(rotations(a.nbytes + w_q.nbytes))]
    ms = time_ms(int8_dense_gelu_quant, sets, 100)
    plain_ms = time_ms(dense_gelu_quant_plain, sets[:4], 20)
    lib_ms = time_ms(library, sets, 50)
    nbytes = (a.nbytes + w_q.nbytes + w_s.nbytes + b.nbytes + got_q.nbytes
              + got_s.nbytes)
    b_ms, b_by = bound(nbytes, 2 * M * K * N, PEAK_INT8)
    return {"shape": [M, K, N], "max_abs_err": diff.max().item(),
            "code_mismatch_frac": frac, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def build_model(torch, cfg, device):
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    t0 = time.perf_counter()
    static = quantize_params_static(random_dense_params(cfg, SEED))
    t1 = time.perf_counter()
    model = DiT(cfg, static, device=device)
    log(f"[model] v3 int8_static weights: {t1 - t0:.1f} s to draw and "
        f"quantize, {time.perf_counter() - t1:.1f} s to place")
    return model, static


def profile_phase(torch, name, fn):
    """Trace ``fn()`` with torch.profiler: the card's busy share over the
    phase's wall time, and device time by kernel name."""
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
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    log(f"[profile {name}] wall {wall / 1e3:.1f} ms (traced), device busy "
        f"{busy / 1e3:.1f} ms = {busy / wall:.1%}, {len(kernels)} kernels")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        log(f"[profile {name}] {us / 1e3:8.2f} ms {us / busy:6.1%}  "
            f"{kname[:100]}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one more sampler call and decode with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    import numpy as np

    from jatsr_torch.configs import SamplerConfig, get_preset
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.models.dac import DAC, DACConfig
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.ops import _build
    from jatsr_torch.ops.attention import gqa_attention_flash_qkv
    from jatsr_torch.ops.int8_matmul import int8_dense_gelu_quant
    from jatsr_torch.train.step import Normalizer
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
    _build.load("flash_qkv")
    log(f"[build] {_build.build_seconds:.1f} s for all kernels")
    for name in ("flash_qkv", "dense_gelu_quant"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # 3. Kernels against their plain versions at the path's shapes.
    attn = check_attention(torch)
    log(f"[kernel] flash_qkv {json.dumps(attn)}")
    mlp_in = check_dense_gelu(torch, 2070, 1280, 5120)
    log(f"[kernel] dense_gelu_quant mlp_in {json.dumps(mlp_in)}")
    patch = check_dense_gelu(torch, 2070, 8192, 512)
    log(f"[kernel] dense_gelu_quant patch_embed {json.dumps(patch)}")

    # 4. The serving path at full width: v3, int8_static, no fused prologue.
    cfg = dataclasses.replace(
        get_preset("v3").model, param_dtype="bfloat16", dropout=0.0,
        drop_path_rate=0.0, matmul_precision="int8_static", fused_qkv=True,
        fused_mlp=True, fused_mlp_impl="half", attention_impl="flash",
        flash_qkv=True, gelu_impl="tanh", fast_epilogue=True,
        fused_prologue=False, align_n=False, int8_impl="xla")
    model, static = build_model(torch, cfg, "cuda")
    codec = DAC.random_init(SEED, DACConfig(), device="cuda")
    C = cfg.input_channels
    norm = Normalizer(np.zeros(C), np.ones(C), np.zeros(C), np.ones(C))
    pipe = InferencePipeline(model, norm, codec,
                             SamplerConfig(num_steps=STEPS,
                                           cfg_scale=CFG_SCALE))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = torch.randn((LATENT_FRAMES, C), generator=gen, device="cuda")
    audio_sec = LATENT_FRAMES * 512 / 44100

    def sample():
        return pipe.super_resolve_latent_device(lr, SEED, STEPS, CFG_SCALE,
                                                max_batch=3)

    def decode(latent):
        return pipe.decode_latent_pieces(latent, SEGMENT_FRAMES, CTX_FRAMES)

    def serve():
        t0 = time.perf_counter()
        latent = sample()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pieces = decode(latent)
        torch.cuda.synchronize()
        return latent, pieces, t1 - t0, time.perf_counter() - t0

    serve()  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.reset_peak_memory_stats()
    gqa_attention_flash_qkv.launches = 0
    int8_dense_gelu_quant.launches = 0
    latent, pieces, t_sample, t_e2e = serve()
    launches = {"flash_qkv": gqa_attention_flash_qkv.launches,
                "dense_gelu_quant": int8_dense_gelu_quant.launches}
    times = [(t_sample, t_e2e)] + [serve()[2:] for _ in range(TIMED_RUNS - 1)]
    expected = {"flash_qkv": STEPS * cfg.depth,
                "dense_gelu_quant": STEPS * (cfg.depth + 1)}
    log(f"[serve] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    wav = torch.cat(pieces)
    if latent.shape != (LATENT_FRAMES, C) or not bool(
            torch.isfinite(latent).all()):
        raise AssertionError(f"latent {tuple(latent.shape)} not finite/shaped")
    if wav.shape != (LATENT_FRAMES * 512,):
        raise AssertionError(f"wav length {wav.shape[0]} != {LATENT_FRAMES * 512}")
    if not bool(torch.isfinite(wav).all()) or wav.abs().max().item() > 1.0:
        raise AssertionError("wav not finite or outside [-1, 1]")
    log(f"[serve] {audio_sec:.2f} s of audio, {len(pieces)} decode segments, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t_sample = sorted(t for t, _ in times)[len(times) // 2]
    t_e2e = sorted(t for _, t in times)[len(times) // 2]
    log(f"[serve] {TIMED_RUNS} runs, sampler ms "
        f"{[round(t * 1e3, 1) for t, _ in times]}, end-to-end ms "
        f"{[round(t * 1e3, 1) for _, t in times]}")
    log(f"[serve] median: sampler {audio_sec / t_sample:.2f} audio-sec/s "
        f"({t_sample * 1e3:.1f} ms), end to end {audio_sec / t_e2e:.2f} "
        f"audio-sec/s ({t_e2e * 1e3:.1f} ms); {STEPS} steps CFG {CFG_SCALE}, "
        f"batch 6; card: {card}")
    if args.profile:
        profile_phase(torch, "sampler", sample)
        profile_phase(torch, "decode", lambda: decode(latent))

    # 5. Reference on a small input: the same full-width DiT on the card
    #    (kernels) and on the CPU (plain versions).
    del pipe, codec
    cpu_model = DiT(cfg, static, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    x_t = torch.from_numpy(rng.standard_normal((2, 64, C), dtype=np.float32))
    x_c = torch.from_numpy(rng.standard_normal((2, 64, C), dtype=np.float32))
    t = torch.tensor([0.25, 0.75])
    ref = cpu_model(x_t, t, x_c)
    out = model(x_t.cuda(), t.cuda(), x_c.cuda()).cpu()
    rel = ((out - ref).norm() / ref.norm()).item()
    log(f"[reference] card vs CPU plain path, full width, [2, 64, {C}]: "
        f"rel L2 {rel:.3e}, max abs {(out - ref).abs().max().item():.3e}, "
        f"mean |ref| {ref.abs().mean().item():.3e}")
    if not bool(torch.isfinite(out).all()) or rel > 5e-2:
        raise AssertionError(f"card DiT disagrees with the plain path: "
                             f"rel L2 {rel} > 5e-2")

    # Result lines.
    kernels = [
        dict(attn, launches=launches["flash_qkv"]),
        {"name": "dense_gelu_quant", "route": "cuda",
         "source": "jatsr_torch/ops/csrc/dense_gelu_quant.cu",
         "replaces": "ops/int8_matmul.py:254 (JAX package, "
                     "int8_dense_gelu_quant; pallas_call :290)",
         "launches": launches["dense_gelu_quant"],
         **{k: mlp_in[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
         "mlp_in": mlp_in, "patch_embed": patch},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
