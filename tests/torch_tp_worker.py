"""The ranks of ``tests/test_torch_tensor_parallel.py``: the int8 DiT
tensor-parallel over a gloo process group on the CPU.

Spawned (``torch.multiprocessing``, ``spawn``), so this module imports
``torch`` and the port only, never JAX.  :func:`main` joins the group
through a file store under the test's directory, runs every case on a
``(D, M)`` mesh and saves what each rank holds after it to
``<tag><rank>.pt``; at (1, 2) rank 0 then runs each case on one process
(no mesh) with the same thread count, into ``solo.pt``.

``PATHS`` are the serving branches, each at tiny's widths (hidden 128,
4/2 heads of 32, MLP 512): bench.py's default path and
--no-fused-prologue (with ``int8_impl="fused"`` too), then the third path
(``--flash-out --fused-mlp-impl full --int8-impl pallas``: B12, B13 and
B14), --no-flash-qkv (B11), ``--attention pallas`` and ``pallas2`` (B15,
B16), the CLI's ``--int8 --quantize-head`` (the unfused MLP, the int8
head, the einsum attention, fp32 scores), q/k/v apart through B14,
``--flash-int8-qk`` and learned positions with attention biases at 4/4
heads (v1legacy's branch).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from jatsr_torch.configs import SamplerConfig, get_preset
from jatsr_torch.infer import InferencePipeline
from jatsr_torch.infer import pipeline as torch_pipeline
from jatsr_torch.models import dit as dit_module
from jatsr_torch.models.dit import DiT, adaln_tables, rope_cos_sin
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops import split
from jatsr_torch.ops.quant import quantize_params_static, w8a8_dot
from jatsr_torch.parallel import (ModelGroup, local_params, make_mesh,
                                  model_rank, model_size)
from jatsr_torch.parallel.mesh import qkv_columns
from jatsr_torch.train import Normalizer

C = 64            # latent channels: a 512-wide patch
FRAMES = 150      # three 64-frame chunks with 16 frames of overlap
SERVE_KW = dict(num_steps=2, chunk_duration=64 * 512 / 44100,
                overlap_duration=16 * 512 / 44100)
PATHS = {"prologue": dict(fused_prologue=True, align_n=True),
         "no_prologue": dict(fused_prologue=False, align_n=False),
         "no_prologue_fused": dict(fused_prologue=False, align_n=False,
                                   int8_impl="fused"),
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
         "learned": dict(fused_prologue=True, align_n=True,
                         pos_embed="learned", attention_bias=True,
                         num_kv_heads=4)}
FAULT_N = 984     # patches: tiny's flash gate fails at 4/2 heads, passes at
                  # a rank's 2/1 (flash_supported)


def serve_cfg(**knobs):
    """bench.py's default DiT (int8, fused q/k/v, flash-QKV, the "half"
    fused MLP; ``knobs`` add the prologue or take it off) at tiny's 4/2
    heads and MLP 512, hidden 128, bottleneck 128."""
    return dataclasses.replace(get_preset("tiny").model, **{
        **dict(bottleneck_dim=128, input_channels=C, cond_channels=C,
               norm="rms", matmul_precision="int8_static",
               attention_impl="flash", fused_qkv=True, fused_mlp=True),
        **knobs})


def static_tree(cfg):
    return quantize_params_static(random_dense_params(cfg, 7), cfg)


def serve_inputs():
    """Seeded stats (4 x [C]) and an LR latent [FRAMES, C]."""
    rng = np.random.default_rng(31)
    stats = [rng.uniform(0.5, 1.5, C).astype(np.float32) if i % 2
             else rng.standard_normal(C).astype(np.float32)
             for i in range(4)]
    return stats, rng.standard_normal((FRAMES, C)).astype(np.float32)


def forward_inputs():
    """``x_t``, ``t``, ``x_cond`` [2, 64, C] and a given AdaLN table
    [depth, 2, 6H] bf16 (96 frames: 24 patches)."""
    g = torch.Generator().manual_seed(3)
    depth, H = get_preset("tiny").model.depth, 128
    x_t, x_c = (torch.randn(2, 96, C, generator=g) for _ in range(2))
    table = (0.3 * torch.randn(depth, 2, 6 * H, generator=g)).bfloat16()
    return x_t, torch.tensor([0.3, 0.7]), x_c, table


def split_inputs():
    """B1's (x, scale, shift), B5's rows, B4's rows and the kernels: hidden
    128, MLP 512, out_proj [128, 128]."""
    g = torch.Generator().manual_seed(5)
    H, N = 128, 512
    x = torch.randn(2, 24, H, generator=g).bfloat16()
    sc, sh = (0.1 * torch.randn(1, H, generator=g) for _ in range(2))
    w1 = torch.randint(-127, 128, (H, N), generator=g, dtype=torch.int8)
    ws1 = 1e-3 * torch.rand(1, N, generator=g)
    b1 = 0.1 * torch.randn(1, N, generator=g)
    a = torch.randn(48, H, generator=g).bfloat16()
    a[3] = 0.0  # an all-zero row
    wo = torch.randint(-127, 128, (H, H), generator=g, dtype=torch.int8)
    wso = 1e-3 * torch.rand(1, H, generator=g)
    return x, sc, sh, w1, ws1, b1, a, wo, wso


def more_split_inputs():
    """B12's fused qkv [2, 24, 256] (4/2 heads of 32), RoPE tables and out
    projection [128, 128] with a bias; B13's rows [48, 128] and two MLPs:
    512 wide (one slab, which the ranks share) and 2560 (two slabs of 1280:
    at M = 2 a rank holds one)."""
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn(2, 24, 256, generator=g).bfloat16()
    cos, sin = rope_cos_sin(24, 32)
    wo = torch.randint(-127, 128, (128, 128), generator=g, dtype=torch.int8)
    wso = 1e-3 * torch.rand(1, 128, generator=g)
    bo = 0.1 * torch.randn(1, 128, generator=g)
    a = torch.randn(48, 128, generator=g).bfloat16()
    mlps = {}
    for n in (512, 2560):
        mlps[n] = (torch.randint(-127, 128, (128, n), generator=g,
                                 dtype=torch.int8),
                   1e-3 * torch.rand(1, n, generator=g),
                   0.1 * torch.randn(1, n, generator=g),
                   torch.randint(-127, 128, (n, 128), generator=g,
                                 dtype=torch.int8),
                   1e-3 * torch.rand(1, 128, generator=g),
                   0.1 * torch.randn(1, 128, generator=g))
    return qkv, cos, sin, wo, wso, bo, a, mlps


def run_splits(group, M, r):
    """The split plain versions on rank r's share (its columns of mlp_in,
    its columns of out_proj's input and rows of its kernel, its heads of
    B12's qkv and rows of wo, its columns of B13's w1 and rows of w2)."""
    x, sc, sh, w1, ws1, b1, a, wo, wso = split_inputs()
    N, H = w1.shape[1], wo.shape[0]
    cols = slice(r * N // M, (r + 1) * N // M)
    rows = slice(r * H // M, (r + 1) * H // M)
    out = {
        "b1": split.int8_norm_mod_dense_gelu_quant_split(
            x, sc, sh, w1[:, cols], ws1[:, cols], b1[:, cols], group),
        "b5": split.int8_dense_gelu_quant_split(
            a, w1[:, cols], ws1[:, cols], b1[:, cols], group,
            fast_epilogue=False),
        "b4": split.int8_matmul_fused_split(
            a[:, rows].contiguous(), wo[rows], wso, group),
        "xla": w8a8_dot(a[:, rows], wo[rows], wso, group=group),
        "b14": split.int8_matmul_split(a[:, rows].contiguous(), wo[rows],
                                       wso, group)}
    qkv, cos, sin, wo12, wso12, bo12, a13, mlps = more_split_inputs()
    qcols = qkv_columns(serve_cfg(), M, r)  # 4/2 heads of 32
    hrows = slice(r * 128 // M, (r + 1) * 128 // M)
    out["b12"] = split.gqa_attention_flash_out_split(
        qkv[..., qcols], cos, sin, wo12[hrows], wso12, bo12, 4 // M, 2 // M,
        group, n_valid=20)
    for n, (w1q, w1s, bb1, w2q, w2s, bb2) in mlps.items():
        c = slice(r * n // M, (r + 1) * n // M)
        out[f"b13_{n}"] = split.int8_mlp_split(
            a13, w1q[:, c], w1s[:, c], bb1[:, c], w2q[c], w2s, bb2, group,
            rank=r, ranks=M)
    return out


def run_forwards(mesh):
    """Each path's DiT forward on the given AdaLN table, and the tables the
    model computes for ``t``."""
    x_t, t, x_c, table = forward_inputs()
    out = {}
    for name, knobs in PATHS.items():
        cfg = serve_cfg(**knobs)
        model = DiT(cfg, static_tree(cfg), device="cpu", mesh=mesh)
        out[name] = model(x_t, t, x_c, adaln_mod=table)
        out[f"{name}_tables"] = adaln_tables(model, t)
        out[f"{name}_own_tables"] = model(x_t, t, x_c)  # per-block route
    return out


def run_fault(mesh):
    """bench.py's default DiT at FAULT_N patches: the attention each block
    takes (the split q/k/v's einsum, or B2 on the fused qkv) and the
    output."""
    cfg = serve_cfg(**PATHS["prologue"])
    model = DiT(cfg, static_tree(cfg), device="cpu", mesh=mesh)
    g = torch.Generator().manual_seed(4)
    frames = FAULT_N * cfg.patch_len
    x_t, x_c = (torch.randn(1, frames, C, generator=g) for _ in range(2))
    calls = {"einsum": 0, "flash_qkv": 0}
    wrapped = {name: getattr(dit_module, name) for name in (
        "einsum_attention", "gqa_attention_flash_qkv")}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    dit_module.einsum_attention = counted("einsum",
                                          wrapped["einsum_attention"])
    dit_module.gqa_attention_flash_qkv = counted(
        "flash_qkv", wrapped["gqa_attention_flash_qkv"])
    try:
        out = model(x_t, torch.tensor([0.4]), x_c)
    finally:
        for name, fn in wrapped.items():
            setattr(dit_module, name, fn)
    return {"out": out, "calls": calls}


def run_serve(mesh, root: Path):
    """The main path's DiT through the pipeline on three chunks, two Euler
    steps, CFG 2, on the noise the test saved (JAX's draws)."""
    noise = torch.from_numpy(np.load(root / "noise.npy"))
    cfg = serve_cfg(**PATHS["prologue"])
    model = DiT(cfg, static_tree(cfg), device="cpu", mesh=mesh)
    stats, lr = serve_inputs()
    pipe = InferencePipeline(model, Normalizer(*stats, device="cpu"),
                             sampler_cfg=SamplerConfig(**SERVE_KW),
                             device="cpu", mesh=mesh)
    drawn = torch_pipeline._per_chunk_noise
    torch_pipeline._per_chunk_noise = \
        lambda seed, n, frames, channels, device: noise.to(device)
    try:
        return torch.from_numpy(pipe.super_resolve_latent(lr, 0,
                                                          cfg_scale=2.0))
    finally:
        torch_pipeline._per_chunk_noise = drawn


def cli_args(root: Path, out: str, *extra, flags=("--fused-mlp",
                                                  "--fused-prologue",
                                                  "--attention", "flash")):
    """``cli.infer``'s arguments on the test's files: ``--int8`` with
    ``flags`` (bench.py's default path; ``()``: the CLI's own int8
    defaults, the einsum attention, fp32 scores and the unfused MLP)."""
    return ["--torch-checkpoint", str(root / "model.pt"), "--preset", "tiny",
            "--stats", str(root / "stats.json"), "--dac-weights",
            str(root / "dac.pth"), "--input", str(root / "song.lr.npy"),
            "--output-dir", str(root / out), "--steps", "2", "--cfg-scale",
            "2.0", "--platform", "cpu", "--int8", *flags, *extra]


def placement(mesh):
    """Rank's leaves of the main path's tree and its K-major copies."""
    cfg = serve_cfg(**PATHS["prologue"])
    tree = static_tree(cfg)
    M, r = model_size(mesh), model_rank(mesh)
    model = DiT(cfg, tree, device="cpu", mesh=mesh)
    blk = model.blocks[0]
    return {"local": local_params(tree, cfg, M, r),
            "kmajor": {k: tuple(v.shape) for k, v in (
                ("qkv", blk.attn.qkv_kernel_t),
                ("out", blk.attn.out_kernel_t),
                ("mlp_in", blk.mlp_in_kernel_t))},
            "adaln": tuple(model.adaln_kernel.shape)}


def main(rank: int, world: int, root: str, shape) -> None:
    from jatsr_torch.cli import infer as infer_cli

    torch.set_num_threads(1)
    root = Path(root)
    tag = f"tp{shape[0]}x{shape[1]}_"
    dist.init_process_group("gloo", init_method=f"file://{root}/{tag}store",
                            rank=rank, world_size=world)
    mesh = make_mesh(*shape, device="cpu")
    M, r = model_size(mesh), model_rank(mesh)
    out = {"mesh": tuple(mesh.shape), "model_rank": r,
           "splits": run_splits(ModelGroup.of(mesh), M, r),
           "fwd": run_forwards(mesh), "serve": run_serve(mesh, root)}
    if shape == (1, 2):
        out["placement"] = placement(mesh)
        out["fault"] = run_fault(mesh)
        infer_cli.main(cli_args(root, "cli_tp", "--mesh", "1", "2"))
        infer_cli.main(cli_args(root, "cli_int8_tp", "--mesh", "1", "2",
                                flags=()))
    torch.save(out, root / f"{tag}{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0 and shape == (1, 2):
        solo = {"splits": run_splits(None, 1, 0), "fwd": run_forwards(None),
                "serve": run_serve(None, root), "fault": run_fault(None)}
        infer_cli.main(cli_args(root, "cli_solo"))
        infer_cli.main(cli_args(root, "cli_int8_solo", flags=()))
        torch.save(solo, root / "solo.pt")
