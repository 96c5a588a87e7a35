"""CLI: chunked long-audio inference on the card.

Usage:
    python -m jatsr_torch.cli.infer --torch-checkpoint model.pt \
        --preset v3mod2 --stats global_stats_separated.json \
        --input song.wav|song.lr.npy --output-dir out \
        [--steps 50] [--cfg-scale 3.0] [--dac-weights weights.pth]

The port of the JAX package's ``cli/infer.py``, with the same flags.  It
takes a WAV (resampled and encoded to an LR latent through the codec) or a
saved ``.npy`` latent, and writes ``<name>_generated[_cfgX].wav``; for a
latent also ``_lr_input.wav`` and, where the ``.hr.npy`` beside it exists,
``_hr_gt.wav``.  Weights come from ``--torch-checkpoint`` (a reference
``.pt``) or from ``--run-dir`` (a run of ``python -m jatsr_torch.cli.train``:
its ``--checkpoint``, ``best`` by default, and its ``preset.json`` unless
``--preset`` is given); without ``--int8`` the bf16 model serves, with it
the int8 serving
DiT on weights the port quantizes for its config: ``--int8`` alone is the
unfused QuantDense MLP (``--fused-mlp`` the fused one), ``--quantize-head``
adds the int8 output head, and at ``tiny`` (bottleneck 64) the patch embed
is the unfused one.  ``--platform cpu`` runs the plain PyTorch path on the
CPU; otherwise the run uses the card.

``--mesh D M`` samples over a ``(D, M)`` mesh of D x M processes, launched
one a card by torchrun (``torchrun --nproc_per_node 4 -m
jatsr_torch.cli.infer --mesh 2 2 ...``; ``--mesh 1 1`` alone is a world of
one): the chunks data-parallel over D, and at M > 1 the int8 DiT
tensor-parallel over M (``--int8 --fused-mlp --attention flash``, with or
without ``--fused-prologue``: bench.py's default path and its
--no-fused-prologue).  Every rank loads the weights and the input and
keeps its share of the int8 tree; rank 0 alone decodes and writes the
output.  The bf16 model (no ``--int8``) and every other int8 branch raise
``NotImplementedError`` on a model axis past 1 (ROADMAP section A item
8(b)).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run-dir", default=None,
                    help="run dir with training checkpoints")
    ap.add_argument("--checkpoint", default="best",
                    help="checkpoint name inside the run dir")
    ap.add_argument("--torch-checkpoint", default=None,
                    help="a reference train_ddp_*.py .pt checkpoint to "
                         "convert and run directly")
    ap.add_argument("--preset", default=None,
                    help="preset name; v3mod2 when not given")
    ap.add_argument("--stats", required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output-dir", default="inference_output")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cfg-scale", type=float, default=1.0)
    ap.add_argument("--dac-weights", default=None)
    ap.add_argument("--total-seconds", type=float, default=None)
    ap.add_argument("--int8", action="store_true",
                    help="the int8 serving DiT (static W8A8)")
    ap.add_argument("--quantize-head", action="store_true",
                    help="extend int8 to the output head")
    ap.add_argument("--scores-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="attention score storage on the einsum path")
    ap.add_argument("--fused-mlp", action="store_true",
                    help="fused dense+GELU+requant serving MLP (requires "
                         "--int8)")
    ap.add_argument("--fused-mlp-impl", default="half",
                    choices=["half", "full"])
    ap.add_argument("--fused-prologue", action="store_true",
                    help="fold norm+AdaLN+quant into the qkv/mlp_in "
                         "kernels (requires --int8 --fused-mlp --attention "
                         "flash; enables align_n)")
    ap.add_argument("--gelu", default="tanh",
                    choices=["tanh", "erf", "sigmoid"],
                    help="in-kernel GELU form for --fused-mlp")
    ap.add_argument("--no-fast-epilogue", dest="fast_epilogue",
                    action="store_false", default=True)
    ap.add_argument("--attention", default="xla",
                    choices=["xla", "pallas", "pallas2", "flash"])
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="sample over a (data, model) mesh of the "
                         "torchrun processes (model > 1: the int8 DiT "
                         "tensor-parallel)")
    ap.add_argument("--unroll-blocks", action="store_true",
                    help="a compile knob of the JAX package; same math")
    ap.add_argument("--fused-decode", action="store_true", default=True,
                    help="decode through the fused residual-unit and "
                         "upsample kernels (the default); fp32 only: with "
                         "--bf16-decode the decoder takes the conv path "
                         "(warned)")
    ap.add_argument("--no-fused-decode", dest="fused_decode",
                    action="store_false",
                    help="decode through plain fp32 convolutions")
    ap.add_argument("--bf16-decode", action="store_true",
                    help="run the DAC decoder's convolutions in bf16")
    ap.add_argument("--solver", default="euler", choices=["euler", "heun"],
                    help="ODE solver (heun: 2 model calls per step)")
    ap.add_argument("--cfg-interval", type=float, nargs=2,
                    default=(0.0, 1.0), metavar=("LO", "HI"),
                    help="apply CFG only for t in [LO, HI) of the schedule")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the plain path on the CPU; cuda (the "
                         "default) the card")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if not (args.torch_checkpoint or args.run_dir):
        raise SystemExit("need --run-dir or --torch-checkpoint")
    if args.fused_mlp and not args.int8:
        raise SystemExit("--fused-mlp requires --int8")
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")
    device = "cpu" if args.platform == "cpu" else "cuda"
    if args.mesh and args.mesh[1] > 1 and not args.int8:
        raise NotImplementedError(
            f"--mesh {args.mesh[0]} {args.mesh[1]} without --int8: the bf16 "
            f"model on a model axis comes in the next slice of the port "
            f"(ROADMAP section A item 8(b)); the int8 DiT serves on it")

    import numpy as np
    import torch

    from ..configs import Preset, get_preset
    from ..data import load_stats
    from ..infer import InferencePipeline
    from ..models.convert_dit import load_reference_checkpoint
    from ..models.dac import DAC
    from ..models.dit import DenseDiT, DiT
    from ..models.from_jax import dense_tree_from_named
    from ..train.checkpoint import CheckpointManager
    from ..train.step import Normalizer
    from ..utils.audio_io import load_wav, save_wav

    if args.preset:
        preset = get_preset(args.preset)
    else:
        pj = Path(args.run_dir or ".") / "preset.json"
        if pj.exists():
            preset = Preset.from_json(pj.read_text())
            print(f"[infer] preset '{preset.name}' from {pj}")
        else:
            preset = get_preset("v3mod2")
    mesh = None
    if args.mesh:
        from ..parallel import init_distributed, make_mesh

        init_distributed(device=device)
        mesh = make_mesh(*args.mesh, device=device)
        print(f"[infer] serving mesh: data={args.mesh[0]} x "
              f"model={args.mesh[1]}")
    # Checkpoints hold the float parameters; the int8 model is quantized
    # from them after the restore.
    if args.torch_checkpoint:
        params = load_reference_checkpoint(args.torch_checkpoint,
                                           preset.model)
        print(f"[infer] converted reference checkpoint "
              f"{args.torch_checkpoint}")
    else:
        blob = CheckpointManager(args.run_dir, primary=False).load(
            args.checkpoint)
        params = dense_tree_from_named(blob["state"]["params"], preset.model)
        print(f"[infer] restored {args.checkpoint} @ step "
              f"{blob['meta']['global_step']}")
        del blob
    serving = dataclasses.replace(
        preset.model, scores_dtype=args.scores_dtype,
        attention_impl=args.attention, gelu_impl=args.gelu,
        fast_epilogue=args.fast_epilogue,
        fused_mlp_impl=args.fused_mlp_impl,
        fused_prologue=args.fused_prologue, align_n=args.fused_prologue,
        unroll_blocks=args.unroll_blocks)
    print(f"[infer] attention scores dtype: {serving.scores_dtype}")
    if args.int8:
        from ..ops.quant import quantize_params_static

        mcfg = dataclasses.replace(
            serving, matmul_precision="int8_static",
            quantize_head=args.quantize_head, fused_mlp=args.fused_mlp,
            fused_qkv=True, dropout=0.0, drop_path_rate=0.0)
        model = DiT(mcfg, quantize_params_static(params, mcfg),
                    device=device, mesh=mesh)
        print("[infer] int8 serving: weights quantized (static W8A8)")
    else:
        model = DenseDiT(dataclasses.replace(serving, dropout=0.0,
                                             drop_path_rate=0.0),
                         params, device=device)

    dac_dtype = torch.bfloat16 if args.bf16_decode else None
    if args.dac_weights:
        from ..models.dac.convert import load_torch_checkpoint

        codec = DAC(load_torch_checkpoint(args.dac_weights),
                    fused_res_units=args.fused_decode, device=device,
                    compute_dtype=dac_dtype)
    else:
        print("[warn] no --dac-weights: RANDOM codec (testing only)")
        codec = DAC.random_init(0, fused_res_units=args.fused_decode,
                                device=device, compute_dtype=dac_dtype)

    norm = Normalizer(*load_stats(args.stats), device=device)
    scfg = dataclasses.replace(
        preset.sampler, num_steps=args.steps, cfg_scale=args.cfg_scale,
        cfg_interval=tuple(args.cfg_interval), solver=args.solver)
    print(f"[infer] sampler: {scfg.solver}-{scfg.num_steps}, "
          f"cfg_scale={scfg.cfg_scale}, "
          f"cfg_interval=({scfg.cfg_interval[0]}, {scfg.cfg_interval[1]})"
          + ("" if scfg.cfg_interval == (0.0, 1.0)
             else " [non-parity guidance schedule]"))
    pipe = InferencePipeline(model, norm, codec, scfg, device=device,
                             mesh=mesh)

    out = Path(args.output_dir)
    if pipe.primary:
        out.mkdir(parents=True, exist_ok=True)
    inp = Path(args.input)
    cfg_suffix = f"_cfg{args.cfg_scale:.1f}" if args.cfg_scale != 1.0 else ""
    if inp.suffix == ".npy":
        lr_latent = np.load(inp).astype(np.float32)
        if args.total_seconds:
            lr_latent = lr_latent[:int(args.total_seconds * 44100 / 512)]
        gen = pipe.super_resolve_latent(lr_latent, 0, args.steps,
                                        args.cfg_scale)
        if not pipe.primary:
            return
        save_wav(out / f"{inp.stem}_generated{cfg_suffix}.wav",
                 pipe.decode_latent(gen), 44100)
        save_wav(out / f"{inp.stem}_lr_input.wav",
                 pipe.decode_latent(lr_latent), 44100)
        hr_path = Path(str(inp).replace(".lr.npy", ".hr.npy"))
        if hr_path != inp and hr_path.exists():
            hr = np.load(hr_path).astype(np.float32)[: len(lr_latent)]
            save_wav(out / f"{inp.stem}_hr_gt.wav", pipe.decode_latent(hr),
                     44100)
    else:
        audio, sr = load_wav(inp, mono=True)
        if args.total_seconds:
            audio = audio[: int(args.total_seconds * sr)]
        wav = pipe.super_resolve_audio(audio, sr, 0, args.steps,
                                       args.cfg_scale)
        if not pipe.primary:
            return
        save_wav(out / f"{inp.stem}_generated{cfg_suffix}.wav", wav, 44100)
    print(f"[infer] wrote results to {out}/")


if __name__ == "__main__":
    main()
