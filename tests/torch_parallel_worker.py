"""The ranks of ``tests/test_torch_parallel.py``: data-parallel training and
serving of the port over a gloo process group on the CPU.

Spawned (``torch.multiprocessing``, ``spawn``), so this module imports
``torch`` and the port only, never JAX.  :func:`main` joins the group
through a file store under the test's directory, runs every case on a
``(2, 1)`` mesh and saves what each rank holds after it to
``out<rank>.pt``; rank 0 also runs each case on one process (no mesh) with
the same thread count, into ``solo.pt``.  The same functions with
``mesh=None`` are the single-process runs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from jatsr_torch.configs import LossConfig, SamplerConfig, TrainConfig
from jatsr_torch.configs import get_preset
from jatsr_torch.infer import InferencePipeline
from jatsr_torch.models.dit import DenseDiT, DiT
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.ops.quant import quantize_params_static
from jatsr_torch.parallel import make_mesh
from jatsr_torch.train import (Normalizer, create_train_state,
                               make_eval_step, make_train_step)
from jatsr_torch.train.loop import Trainer

C = 32            # the trained DiT's latent channels
T = 64            # frames a training crop: 16 patches
SERVE_C = 64      # the served DiT's latent channels (a 512-wide patch)

# name -> (the model's knobs, the train config's, the global batch).  Each
# runs two steps with dropout and drop-path on; "accum" cuts three
# micro-batches of two rows over ranks of three rows (unequal pieces), on
# the einsum attention under the "attn_out" segments.
STEP_CASES = {
    "fp32": ({}, {}, 4),
    "accum": ({"train_attention_impl": "xla", "remat_policy": "attn_out"},
              {"grad_accum_steps": 3}, 6),
    "bf16": ({"param_dtype": "bfloat16"}, {}, 4),
}


def train_model_cfg(**knobs):
    """tiny at ``C`` channels, dropout 0.1 and drop-path 0.1."""
    return dataclasses.replace(
        get_preset("tiny").model, input_channels=C, cond_channels=C,
        dropout=0.1, drop_path_rate=0.1, **knobs)


def train_cfg(B, **kw):
    return TrainConfig(batch_size=B, lr=1e-3, warmup_steps=0,
                       cfg_dropout_prob=0.3, condition_noise_ratio=0.05,
                       **kw)


def step_batch(B):
    rng = np.random.default_rng(21)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    stats = (0.1 * rng.standard_normal(C).astype(np.float32),
             (0.5 + rng.random(C)).astype(np.float32),
             0.1 * rng.standard_normal(C).astype(np.float32),
             (0.5 + rng.random(C)).astype(np.float32))
    return hr, lr, stats


def run_steps(mesh, name, shard_opt_state=False, steps=2):
    """Two train steps of case ``name`` on this rank's rows (all of them
    without a mesh): the whole state after them (moments gathered), each
    step's metrics, and one eval step's metrics."""
    knobs, tkw, B = STEP_CASES[name]
    cfg = train_model_cfg(**knobs)
    tcfg = train_cfg(B, **tkw)
    hr, lr, stats = step_batch(B)
    rows = slice(0, B)
    if mesh is not None:
        from jatsr_torch.parallel import batch_rows

        rows = batch_rows(mesh, B)
    hr, lr = torch.from_numpy(hr[rows]), torch.from_numpy(lr[rows])
    model = DenseDiT(cfg, random_dense_params(cfg, 5), device="cpu")
    state = create_train_state(model, tcfg, 100, (hr, lr), device="cpu",
                               mesh=mesh, shard_opt_state=shard_opt_state)
    norm = Normalizer(*stats, device="cpu")
    step = make_train_step(LossConfig(), tcfg, norm, mesh=mesh)
    metrics = []
    for _ in range(steps):
        state, m = step(state, hr, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = make_eval_step(LossConfig(), norm, mesh=mesh)(state, hr, lr, seed=3)
    sd = state.state_dict()
    return {"params": {k: v.clone() for k, v in sd["params"].items()},
            "mu": {k: v.clone() for k, v in sd["opt"]["mu"].items()},
            "nu": {k: v.clone() for k, v in sd["opt"]["nu"].items()},
            "metrics": metrics,
            "eval": {k: float(v) for k, v in ev.items()},
            "local_mu_numel": sum(m.numel() for m in state.opt_state.mu)}


def mini_dataset(root: Path, n_songs=3, frames=120):
    """``tests/test_torch_trainer.py``'s latents: ``C`` channels, three
    train songs and two validation songs of 120 frames."""
    rs = np.random.RandomState(0)
    for split, count in [("train", n_songs), ("val", 2)]:
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            hr = rs.randn(frames, C).astype(np.float16)
            lr = (0.8 * hr + 0.1 * rs.randn(frames, C)).astype(np.float16)
            np.save(d / f"s{i}.hr.npy", hr)
            np.save(d / f"s{i}.lr.npy", lr)
    stats = {"hr_mean": [0.0] * C, "hr_std": [1.0] * C,
             "lr_mean": [0.0] * C, "lr_std": [1.0] * C, "total_frames": 1}
    (root / "global_stats_separated.json").write_text(json.dumps(stats))


def fit_preset(root: Path):
    """tiny at ``C`` channels, dropout on, global batch 2 of 64-frame
    crops, one epoch of three steps, ZeRO-1 asked for (it acts under a
    mesh)."""
    p = get_preset("tiny")
    return dataclasses.replace(
        p,
        model=dataclasses.replace(p.model, input_channels=C, cond_channels=C,
                                  dropout=0.1, drop_path_rate=0.1),
        train=dataclasses.replace(
            p.train, batch_size=2, save_dir_base=str(root / "ckpt"),
            log_dir_base=str(root / "runs"), save_interval_steps=2,
            keep_interval_checkpoints=1, num_epochs=1, warmup_steps=1,
            lr=1e-3, log_interval_steps=1, shard_opt_state=True),
        data=dataclasses.replace(p.data, target_duration=T * 512 / 44100,
                                 samples_per_epoch_multiplier=2))


def state_tensors(state):
    sd = state.state_dict()
    return {**{f"p.{k}": v.clone() for k, v in sd["params"].items()},
            **{f"mu.{k}": v.clone() for k, v in sd["opt"]["mu"].items()},
            **{f"nu.{k}": v.clone() for k, v in sd["opt"]["nu"].items()},
            "step": state.step, "count": state.opt_state.count}


def run_fit(mesh, root: Path, run_name: str, resume=None):
    """``Trainer.fit`` of one epoch (or, with ``resume``, the restored
    trainer without a step): its state, best validation loss and run
    directory."""
    tr = Trainer(fit_preset(root), data_dir=str(root / "data"),
                 resume=resume, mesh=mesh, run_name=run_name, writer=False,
                 device="cpu")
    best = float("nan") if resume else tr.fit(verbose=False)
    return {"state": state_tensors(tr.state), "best": best,
            "run_dir": str(tr.ckpt.run_dir), "start_epoch": tr.start_epoch}


def serve_cfg():
    """The main path's DiT (``bench.py``'s default: int8 with the fused
    prologue and ``align_n``) at ``tests/torch_parity.py``'s narrow width."""
    return dataclasses.replace(
        get_preset("tiny").model, bottleneck_dim=128, input_channels=SERVE_C,
        cond_channels=SERVE_C, norm="rms", matmul_precision="int8_static",
        attention_impl="flash", fused_qkv=True, fused_mlp=True,
        fused_prologue=True, align_n=True)


SERVE_KW = dict(num_steps=2, chunk_duration=66 * 512 / 44100,
                overlap_duration=16 * 512 / 44100)


def serve_inputs():
    rng = np.random.default_rng(31)
    stats = [rng.uniform(0.5, 1.5, SERVE_C).astype(np.float32) if i % 2
             else rng.standard_normal(SERVE_C).astype(np.float32)
             for i in range(4)]
    lr = rng.standard_normal((250, SERVE_C)).astype(np.float32)  # 5 chunks
    return stats, lr


def run_serve(mesh):
    """The int8 DiT through the pipeline on five chunks: in one group (six
    rows under the mesh, one null) and in groups of two (the tail padded);
    per-chunk and group noise."""
    cfg = serve_cfg()
    model = DiT(cfg, quantize_params_static(random_dense_params(cfg, 7),
                                            cfg), device="cpu")
    stats, lr = serve_inputs()
    out = {}
    for noise in ("per_chunk", "batch"):
        pipe = InferencePipeline(
            model, Normalizer(*stats, device="cpu"),
            sampler_cfg=SamplerConfig(chunk_noise=noise, **SERVE_KW),
            device="cpu", mesh=mesh)
        for mb in (0, 2):
            out[f"{noise}_{mb}"] = torch.from_numpy(pipe.super_resolve_latent(
                lr, 4, cfg_scale=2.0, max_batch=mb))
    return out


def main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=world)
    mesh = make_mesh(-1, 1, device="cpu")
    out = {"mesh": tuple(mesh.shape)}
    for name in STEP_CASES:
        out[name] = run_steps(mesh, name)
        out[f"{name}_zero"] = run_steps(mesh, name, shard_opt_state=True)
    out["serve"] = run_serve(mesh)
    out["fit"] = run_fit(mesh, root, "22220000")
    out["from_solo"] = run_fit(mesh, root, None,
                               resume=str(root / "ckpt" / "tiny" / "11110000"))
    torch.save(out, root / f"out{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        solo = {name: run_steps(None, name) for name in STEP_CASES}
        solo["serve"] = run_serve(None)
        torch.save(solo, root / "solo.pt")
