"""CLI: offline preprocessing on the card (the reference's
prepare_dataset_v5.py).

Usage:
    python -m jatsr_torch.cli.prepare_dataset --source-dirs DIR [DIR...] \
        --output-dir data_processed [--dac-weights weights.pth]

The port of the JAX package's ``cli/prepare_dataset.py``, with the same
flags.  Scans WAVs, splits 90/10 with seed 42, chunks 7 s (+0.5 s context),
simulates 16 kHz LR, DAC-encodes on the card, writes fp16 latents and the
global stats, and resumes from ``processed_files.jsonl`` on a re-run.
``--platform cpu`` runs the plain PyTorch path on the CPU; otherwise the
encode runs on the card.
"""

from __future__ import annotations

import argparse
import dataclasses


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source-dirs", nargs="+", required=True)
    ap.add_argument("--output-dir", default="data_processed")
    ap.add_argument("--dac-weights", default=None,
                    help="Path to a torch DAC 44 kHz checkpoint (.pth); "
                         "random weights (testing only) if omitted")
    ap.add_argument("--val-ratio", type=float, default=0.1)
    ap.add_argument("--chunk-duration", type=float, default=7.0)
    ap.add_argument("--overlap-duration", type=float, default=0.5)
    ap.add_argument("--num-shards", type=int, default=1,
                    help="partition the file list across hosts")
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--encode-devices", type=int, default=1,
                    help="round-robin song encodes over the first N CUDA "
                         "devices with deferred fetches (the reference's "
                         "one-worker-per-GPU pool, prepare_dataset_v5.py:"
                         "326-381); 0 = all of them")
    ap.add_argument("--chunking", default="overlap",
                    choices=["overlap", "plain", "whole"],
                    help="historical preprocessing generation "
                         "(overlap=v4/v5 default, plain=v3, whole=v2)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the plain path on the CPU; cuda (the "
                         "default) the card")
    return ap


def encode_devices(n: int, device: str):
    """The ``--encode-devices`` list: None for one device, else the first
    ``n`` CUDA devices (all for 0).  The CPU is one device."""
    import torch

    if n == 1:
        return None
    if device == "cpu":
        raise SystemExit("--encode-devices counts CUDA devices; the CPU is "
                         "one (--platform cpu takes 1)")
    have = torch.cuda.device_count()
    n = n or have
    if not 0 < n <= have:
        raise SystemExit(f"--encode-devices {n}: this machine has {have} "
                         f"CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")
    device = "cpu" if args.platform == "cpu" else "cuda"

    from ..configs import DataConfig
    from ..data import PreprocessPipeline
    from ..models.dac import DAC
    from ..utils.device import resolve_device

    resolve_device(device)
    if args.dac_weights:
        from ..models.dac.convert import load_torch_checkpoint

        codec = DAC(load_torch_checkpoint(args.dac_weights), device=device)
    else:
        print("[warn] no --dac-weights given: using RANDOM codec weights "
              "(shape-correct, for pipeline testing only)")
        codec = DAC.random_init(0, device=device)

    cfg = dataclasses.replace(
        DataConfig(),
        val_ratio=args.val_ratio,
        chunk_duration=args.chunk_duration,
        overlap_duration=args.overlap_duration,
        chunking=args.chunking,
    )
    pipe = PreprocessPipeline(codec, cfg, args.output_dir,
                              devices=encode_devices(args.encode_devices,
                                                     device))
    counts = pipe.run(args.source_dirs, num_shards=args.num_shards,
                      shard_index=args.shard_index)
    print(f"[prepare_dataset] {counts}")
    return counts


if __name__ == "__main__":
    main()
