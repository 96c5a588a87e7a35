"""CLI: training on the card.

Usage:
    python -m jatsr_torch.cli.train --preset v3mod2 --data-dir data_processed \
        [--resume [auto|RUN_DIR]] [--epochs N] [--max-steps N] \
        [--native-loader] [--remat full|attn_out|mlp|dots|none]

The port of the JAX package's ``cli/train.py``, with its flags.  Runs go
under ``<save_dir_base>/<preset>/<run name>/`` (``checkpoints/`` by
default): ``last``, ``best``, ``interval_<step>`` and ``preset.json``;
``python -m jatsr_torch.cli.infer --run-dir`` serves them.  ``--platform
cpu`` runs the plain PyTorch path on the CPU; otherwise the run uses the
card.  ``--profile-steps N`` traces the first N steps with
``torch.profiler`` into ``<run dir>/profile``.  ``--mesh`` and
``--distributed`` raise ``NotImplementedError``: multi-card training
comes with ``parallel/``; ``--shard-opt-state`` acts only with a mesh.
"""

from __future__ import annotations

import argparse
import dataclasses

_MULTI_CARD = "needs parallel/ (ROADMAP section A item 8)"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="v3mod2")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--resume", nargs="?", const="auto", default=None)
    ap.add_argument("--mesh", nargs=2, type=int, default=None,
                    metavar=("DATA", "MODEL"),
                    help="data x model parallel mesh (not ported yet)")
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
                    help="multi-process training (not ported yet)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(f"--mesh {_MULTI_CARD}")
    if args.distributed:
        raise NotImplementedError(f"--distributed {_MULTI_CARD}")
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")
    device = "cpu" if args.platform == "cpu" else "cuda"

    from ..configs import get_preset
    from ..train.loop import Trainer

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
                      native_loader=args.native_loader,
                      run_name=args.run_name, device=device)
    print(f"[train] preset={preset.name} params={trainer.n_params / 1e6:.1f}M "
          f"steps/epoch={len(trainer.train_loader)} device={device}")
    if args.profile_steps:
        from ..utils.profiling import trace

        with trace(str(trainer.ckpt.run_dir / "profile")):
            trainer.fit(num_epochs=args.epochs,
                        max_steps=trainer.state.step + args.profile_steps)
        print(f"[train] profile trace in {trainer.ckpt.run_dir}/profile")
    best = trainer.fit(num_epochs=args.epochs, max_steps=args.max_steps)
    print(f"[train] done; best val loss {best:.5f}")
    return trainer


if __name__ == "__main__":
    main()
