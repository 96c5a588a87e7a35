"""CLI: training on the card.

Usage:
    python -m jatsr_torch.cli.train --preset v3mod2 --data-dir data_processed \
        [--resume [auto|RUN_DIR]] [--epochs N] [--max-steps N] \
        [--native-loader] [--remat full|attn_out|mlp|dots|none]

Data-parallel on N cards of one host, one process a card (``--mesh D M``
with D x M = N: tensor-parallel over M of them):
    torchrun --nproc_per_node N -m jatsr_torch.cli.train --distributed \
        --mesh N 1 [--shard-opt-state] --preset v3mod2 --data-dir ...

The port of the JAX package's ``cli/train.py``, with its flags.  Runs go
under ``<save_dir_base>/<preset>/<run name>/`` (``checkpoints/`` by
default): ``last``, ``best``, ``interval_<step>`` and ``preset.json``;
``python -m jatsr_torch.cli.infer --run-dir`` serves them.  ``--platform
cpu`` runs the plain PyTorch path on the CPU; otherwise the run uses the
card.  ``--profile-steps N`` traces the first N steps with
``torch.profiler`` into ``<run dir>/profile`` (rank 0's steps under a
mesh).  ``--distributed`` joins
the process group from torchrun's environment (``--platform cpu``: gloo,
else NCCL, one card a rank); ``--mesh D M`` trains over a ``(D, M)`` mesh
of the group's D x M processes, data-parallel over D and tensor-parallel
over M (the JAX CLI's stand-in for
``torchrun --nproc_per_node=N`` is ``--mesh N 1``; here torchrun launches
the processes and ``--mesh`` lays them out; ``--mesh 1 1`` without a
launcher is a world of one).  ``--batch-size`` is the global batch; it
must divide by D.  ``--shard-opt-state`` splits the Adam moments over the
data axis (ZeRO-1) and acts only with a mesh.  Checkpoints hold whole
leaves: a run resumes on any mesh.
"""

from __future__ import annotations

import argparse
import dataclasses


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="v3mod2")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--resume", nargs="?", const="auto", default=None)
    ap.add_argument("--mesh", nargs=2, type=int, default=None,
                    metavar=("DATA", "MODEL"),
                    help="data x model mesh over the process group: "
                         "data-parallel over DATA, tensor-parallel over "
                         "MODEL")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--shard-opt-state", action="store_true",
                    help="ZeRO-1: shard Adam moments over the data axis "
                         "(acts only with a mesh)")
    ap.add_argument("--native-loader", action="store_true",
                    help="assemble batches in the C++ engine (native/)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--warmup-steps", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--cfg-dropout", type=float, default=None,
                    help="sample-level condition dropout (CFG training)")
    ap.add_argument("--save-last-every", type=int, default=None,
                    help="save the `last` checkpoint every N epochs")
    ap.add_argument("--save-best-every", type=int, default=None,
                    help="save the `best` checkpoint on improvement at most "
                         "every N epochs")
    ap.add_argument("--run-name", default=None,
                    help="run dir name (default: MMDDHHMM timestamp)")
    ap.add_argument("--remat", default=None,
                    choices=["full", "attn_out", "mlp", "dots", "none"],
                    help="rematerialisation policy (ModelConfig.remat_policy)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="trace the first N steps with torch.profiler")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the plain path on the CPU; cuda (the "
                         "default) the card")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group from torchrun's "
                         "environment (MASTER_ADDR, MASTER_PORT, RANK, "
                         "WORLD_SIZE, LOCAL_RANK)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")
    device = "cpu" if args.platform == "cpu" else "cuda"

    from ..configs import get_preset
    from ..parallel import init_distributed, is_primary, make_mesh
    from ..train.loop import Trainer

    if args.distributed:
        init_distributed(device=device)
    mesh = make_mesh(*args.mesh, device=device) if args.mesh else None

    preset = get_preset(args.preset)
    over = {"batch_size": args.batch_size or None,
            "shard_opt_state": args.shard_opt_state or None,
            "lr": args.lr, "warmup_steps": args.warmup_steps,
            "grad_accum_steps": args.grad_accum,
            "cfg_dropout_prob": args.cfg_dropout,
            "save_last_every_epochs": args.save_last_every,
            "save_best_every_epochs": args.save_best_every}
    over = {k: v for k, v in over.items() if v is not None}
    if over:
        preset = dataclasses.replace(
            preset, train=dataclasses.replace(preset.train, **over))
    if args.remat:
        preset = dataclasses.replace(preset, model=dataclasses.replace(
            preset.model, remat_policy=args.remat))
    trainer = Trainer(preset, data_dir=args.data_dir, resume=args.resume,
                      mesh=mesh, native_loader=args.native_loader,
                      run_name=args.run_name, device=device)
    say = print if is_primary() else (lambda *a, **k: None)
    say(f"[train] preset={preset.name} params={trainer.n_params / 1e6:.1f}M "
        f"steps/epoch={len(trainer.train_loader)} device={device} "
        f"mesh={args.mesh}")
    if args.profile_steps:
        import contextlib

        from ..utils.profiling import trace

        with (trace(str(trainer.ckpt.run_dir / "profile")) if is_primary()
              else contextlib.nullcontext()):
            trainer.fit(num_epochs=args.epochs,
                        max_steps=trainer.state.step + args.profile_steps)
        say(f"[train] profile trace in {trainer.ckpt.run_dir}/profile")
    best = trainer.fit(num_epochs=args.epochs, max_steps=args.max_steps)
    say(f"[train] done; best val loss {best:.5f}")
    return trainer


if __name__ == "__main__":
    main()
