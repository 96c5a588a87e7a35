"""The ranks of ``tests/test_torch_tp_train.py``: ``DenseDiT`` trained and
served tensor-parallel over a gloo process group on the CPU.

Spawned (``torch.multiprocessing``, ``spawn``), so this module imports
``torch`` and the port only, never JAX.  :func:`main` joins the group
through a file store under the test's directory, runs every case on a
``(D, M)`` mesh and saves what each rank holds after it to
``<tag><rank>.pt``; at (1, 2) rank 0 then runs each case on one process
(no mesh) with the same thread count, into ``solo.pt``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from jatsr_torch.configs import (LossConfig, SamplerConfig, TrainConfig,
                                 get_preset)
from jatsr_torch.infer import InferencePipeline
from jatsr_torch.infer import pipeline as torch_pipeline
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.parallel import (batch_rows, make_mesh, model_rank,
                                  model_size)
from jatsr_torch.train import (CheckpointManager, Normalizer,
                               create_train_state, make_train_step)

C = 32            # latent channels of the step and gradient cases
B, T = 4, 24      # global batch, frames (6 patches)
DROP = dict(dropout=0.1, drop_path_rate=0.05)
POLICIES = ("full", "dots", "attn_out", "mlp", "none")
JAX_KNOBS = dict(train_attention_impl="xla")  # the JAX step's branch
SERVE_C = 64      # the served model's channels
SERVE_KW = dict(num_steps=2, chunk_duration=64 * 512 / 44100,
                overlap_duration=16 * 512 / 44100)

# name -> the model's knobs of a two-step case (B10's plain versions with
# dropout and drop-path on; the JAX comparison takes tiny's knobs and the
# einsum attention, ``JAX_KNOBS``).
STEP_CASES = {
    "bf16": DROP,
    "fp32": dict(dtype="float32", **DROP),
    "bf16_params": dict(param_dtype="bfloat16", **DROP),
    "einsum": dict(train_attention_impl="xla", remat_policy="attn_out",
                   **DROP),
    # Dynamic int8 on B14 (its split entry at out_proj and mlp_out).
    "int8_pallas": dict(matmul_precision="int8", int8_impl="pallas", **DROP),
}


def model_cfg(**knobs):
    """tiny (hidden 128, 4/2 heads of 32, MLP 512, depth 2) at ``C``
    channels."""
    return dataclasses.replace(get_preset("tiny").model, input_channels=C,
                               cond_channels=C, **knobs)


def train_cfg(**kw):
    """Warmup 1: step 0 runs at lr 0, step 1 at 1e-3."""
    return TrainConfig(**{**dict(batch_size=B, lr=1e-3, warmup_steps=1,
                                 cfg_dropout_prob=0.5,
                                 condition_noise_ratio=0.05), **kw})


def step_batch():
    rng = np.random.default_rng(2)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    mu = 0.1 * rng.standard_normal(C).astype(np.float32)
    sd = (0.5 + rng.random(C)).astype(np.float32)
    return hr, lr, (mu, sd, -mu, 2 * sd)


def whole(model, named):
    """``{name: tensor}`` of this rank's parameters' tensors -> whole
    leaves (the split ones gathered over the model group)."""
    out = {}
    for k, t in named.items():
        d = model.split_dims.get(k) if model.tp is not None else None
        out[k] = t.clone() if d is None else model.tp.gather_dim(t, d)
    return out


def run_steps(mesh, knobs, tkw=None, draws=None, dense=None,
              shard_opt_state=False, save=None):
    """Two train steps under the MSE loss on this rank's rows: each step's
    metrics and the whole state after them.  ``draws``: the JAX step's,
    one dict a step; ``save``: a run directory that receives the state as
    checkpoint ``last``."""
    cfg = model_cfg(**knobs)
    tcfg = train_cfg(**(tkw or {}))
    hr, lr, stats = step_batch()
    rows = batch_rows(mesh, B)
    hr, lr = torch.from_numpy(hr[rows]), torch.from_numpy(lr[rows])
    model = DenseDiT(cfg, random_dense_params(cfg, 3) if dense is None
                     else dense, device="cpu", mesh=mesh)
    state = create_train_state(model, tcfg, 100, (hr, lr), device="cpu",
                               mesh=mesh, shard_opt_state=shard_opt_state)
    step = make_train_step(LossConfig(use_latent_perceptual=False), tcfg,
                           Normalizer(*stats, device="cpu"), mesh=mesh)
    metrics = []
    for s in range(2):
        state, m = step(state, hr, lr,
                        draws=None if draws is None else draws[s])
        metrics.append({k: float(v) for k, v in m.items()})
    sd = state.state_dict()
    if save is not None:
        CheckpointManager(save, primary=dist.get_rank() == 0
                          if dist.is_initialized() else True).save(
            "last", state, 0, 1.0)
    return {"metrics": metrics,
            "params": {k: v.clone() for k, v in sd["params"].items()},
            "mu": {k: v.clone() for k, v in sd["opt"]["mu"].items()},
            "nu": {k: v.clone() for k, v in sd["opt"]["nu"].items()}}


def run_grads(mesh, **knobs):
    """The training forward of the whole batch (layer seeds 11, -12) and
    the gradients of ``mean(out^2)``: the output, the whole gradients and
    this rank's gradients of the replicated leaves."""
    cfg = model_cfg(**knobs)
    model = DenseDiT(cfg, random_dense_params(cfg, 4), device="cpu",
                     mesh=mesh)
    g = torch.Generator().manual_seed(6)
    x, c = (torch.randn(2, 48, C, generator=g) for _ in range(2))
    out = model(x, torch.tensor([0.3, 0.8]), c, deterministic=False,
                layer_seeds=[11, -12])
    (out ** 2).mean().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return {"out": out.detach(), "grads": whole(model, grads),
            "replicated": {k: v.clone() for k, v in grads.items()
                           if k not in model.split_dims}}


def placement(mesh):
    """A (1, 2) rank's parameters: each shape, the split dims, and the
    leaves of the tree it was cut from (``local_params``)."""
    from jatsr_torch.parallel import local_params

    cfg = model_cfg()
    tree = random_dense_params(cfg, 3)
    model = DenseDiT(cfg, tree, device="cpu", mesh=mesh)
    local = local_params(tree, cfg, model_size(mesh), model_rank(mesh))
    return {"shapes": {k: tuple(p.shape) for k, p in
                       model.named_parameters()},
            "split": dict(model.split_dims),
            "q_heads": [blk.attn.hq for blk in model.blocks],
            "h0": [blk.attn.h0 for blk in model.blocks],
            "q_proj": torch.as_tensor(local["blocks"]["attn"]["q_proj"]
                                      ["kernel"][1]),
            "q_param": model.blocks[1].attn.q_proj.kernel.detach().clone()}


def serve_cfg():
    """The bf16 DenseDiT served: tiny at ``SERVE_C`` channels, B11."""
    return dataclasses.replace(get_preset("tiny").model,
                               input_channels=SERVE_C,
                               cond_channels=SERVE_C, attention_impl="flash")


def serve_inputs():
    """Seeded stats (4 x [SERVE_C]) and an LR latent [150, SERVE_C]."""
    rng = np.random.default_rng(31)
    stats = [rng.uniform(0.5, 1.5, SERVE_C).astype(np.float32) if i % 2
             else rng.standard_normal(SERVE_C).astype(np.float32)
             for i in range(4)]
    return stats, rng.standard_normal((150, SERVE_C)).astype(np.float32)


def run_serve(mesh, root: Path, name: str):
    """The bf16 DenseDiT (the tree in ``<name>.pt``) through the pipeline on
    three chunks, two Euler steps, CFG 2, on the chunk noise in
    ``noise.npy`` (JAX's draws)."""
    noise = torch.from_numpy(np.load(root / "noise.npy"))
    tree = torch.load(root / f"{name}.pt")
    model = DenseDiT(serve_cfg(), tree, device="cpu", mesh=mesh)
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


# ---- the trainer and the CLIs at tiny's 1024 channels ----------------------

def tiny_codec():
    """``DAC`` where the infer CLI imports it: a narrow random codec of
    1024 latent channels (the production decoder is minutes of CPU)."""
    from jatsr_torch.models import dac as dac_pkg
    from jatsr_torch.models.dac import DAC, DACConfig, init_params

    cfg = DACConfig(encoder_dim=256, encoder_rates=(2, 2), decoder_dim=16,
                    decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
                    codebook_dim=4)

    class TinyDAC(DAC):
        @classmethod
        def random_init(cls, seed=0, cfg_=None, **kw):
            return cls(init_params(cfg, seed), cfg, **kw)

    dac_pkg.DAC = TinyDAC


def cli_files(root: Path):
    """Latents of 1024 channels: two 1400-frame training songs, one
    900-frame validation song, their stats, and a 20-frame ``.npy``."""
    rng = np.random.default_rng(5)
    d = root / "cli"
    for split, frames in (("train", (1400, 1400)), ("val", (900,))):
        (d / "data" / split).mkdir(parents=True)
        for i, n in enumerate(frames):
            hr = rng.standard_normal((n, 1024)).astype(np.float16)
            np.save(d / "data" / split / f"s{i}.hr.npy", hr)
            np.save(d / "data" / split / f"s{i}.lr.npy",
                    (0.5 * hr).astype(np.float16))
    stats = {"hr_mean": (0.1 * rng.standard_normal(1024)).tolist(),
             "hr_std": rng.uniform(0.5, 1.5, 1024).tolist(),
             "lr_mean": (0.1 * rng.standard_normal(1024)).tolist(),
             "lr_std": rng.uniform(0.5, 1.5, 1024).tolist()}
    (d / "stats.json").write_text(json.dumps(stats))
    (d / "data" / "global_stats_separated.json").write_text(
        json.dumps(stats))
    np.save(d / "song.lr.npy",
            rng.standard_normal((20, 1024)).astype(np.float16))


CLI_RUN = "01010102"


def run_cli(root: Path, mesh_args):
    """With ``mesh_args``: ``cli.train --max-steps 1`` then ``cli.infer
    --run-dir`` of its ``last`` (the bf16 model), each on the mesh; without:
    ``cli.infer`` of that run on one process.  From ``cli/`` (the preset's
    run and log directories are relative)."""
    import os

    from jatsr_torch.cli import infer as infer_cli
    from jatsr_torch.cli import train as train_cli

    d = root / "cli"
    os.chdir(d)
    if mesh_args:
        train_cli.main(["--preset", "tiny", "--platform", "cpu", "--data-dir",
                        str(d / "data"), "--max-steps", "1", "--epochs", "1",
                        "--run-name", CLI_RUN, *mesh_args])
    tiny_codec()
    infer_cli.main(["--run-dir", str(d / "checkpoints" / "tiny" / CLI_RUN),
                    "--checkpoint", "last", "--preset", "tiny", "--stats",
                    str(d / "stats.json"), "--input", str(d / "song.lr.npy"),
                    "--output-dir", str(d / ("out_tp" if mesh_args else
                                             "out_solo")),
                    "--steps", "2", "--cfg-scale", "2.0", "--platform", "cpu",
                    *mesh_args])


def run_restore(mesh, root: Path):
    """``Trainer(resume=)`` of the one-process run the test wrote into
    ``fit/``, then one step: the restored state (whole) and the state after
    the step."""
    import torch_parallel_worker as pw
    from jatsr_torch.train.loop import Trainer

    tr = Trainer(pw.fit_preset(root / "fit"), data_dir=str(root / "fit" /
                                                           "data"),
                 resume=str(root / "fit" / "ckpt" / "tiny" / "11110000"),
                 mesh=mesh, writer=False, device="cpu")
    restored = pw.state_tensors(tr.state)
    tr.fit(num_epochs=tr.start_epoch + 1, max_steps=tr.state.step + 1,
           verbose=False)
    return {"restored": restored, "after": pw.state_tensors(tr.state)}


def main(rank: int, world: int, root: str, shape) -> None:
    torch.set_num_threads(1)
    root = Path(root)
    tag = f"tp{shape[0]}x{shape[1]}_"
    dist.init_process_group("gloo", init_method=f"file://{root}/{tag}store",
                            rank=rank, world_size=world)
    mesh = make_mesh(*shape, device="cpu")
    draws = torch.load(root / "draws.pt")
    out = {"mesh": tuple(mesh.shape), "model_rank": model_rank(mesh),
           "jax": run_steps(mesh, JAX_KNOBS, draws=draws["steps"],
                            dense=draws["dense"]),
           "serve": run_serve(mesh, root, "serve_tree")}
    if shape == (2, 2):
        out["bf16"] = run_steps(mesh, STEP_CASES["bf16"],
                                save=root / "ck22")
        out["bf16_zero"] = run_steps(mesh, STEP_CASES["bf16"],
                                     shard_opt_state=True)
    else:
        for name, knobs in STEP_CASES.items():
            out[name] = run_steps(mesh, knobs)
        for policy in POLICIES:
            out[f"grads_{policy}"] = run_grads(mesh, remat_policy=policy,
                                               **DROP)
        out["grads_int8"] = run_grads(mesh, matmul_precision="int8",
                                      **DROP)
        out["grads_int8_pallas"] = run_grads(mesh, matmul_precision="int8",
                                             int8_impl="pallas", **DROP)
        out["restore"] = run_restore(mesh, root)
        out["placement"] = placement(mesh)
        run_cli(root, ["--mesh", "1", "2"])
    torch.save(out, root / f"{tag}{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0 and shape == (1, 2):
        solo = {"jax": run_steps(None, JAX_KNOBS, draws=draws["steps"],
                                 dense=draws["dense"]),
                "serve": run_serve(None, root, "serve_tree")}
        for name, knobs in STEP_CASES.items():
            solo[name] = run_steps(None, knobs)
        for policy in POLICIES:
            solo[f"grads_{policy}"] = run_grads(None, remat_policy=policy,
                                                **DROP)
        solo["grads_int8"] = run_grads(None, matmul_precision="int8", **DROP)
        solo["grads_int8_pallas"] = run_grads(None, matmul_precision="int8",
                                              int8_impl="pallas", **DROP)
        run_cli(root, [])
        torch.save(solo, root / "solo.pt")
