"""CLI: environment check of the port (the reference's
check_dependencies.py).

Usage:
    python -m jatsr_torch.cli.check_env [--platform cpu]

In the shape of the JAX package's ``cli/check_env.py``: import-probes the
port's dependencies and reports their versions, then what the card's path
needs: PyTorch's CUDA and the card (name and power limit, as ``nvidia-smi``
gives them), ``nvcc``, one kernel library built by ``ops/_build.py`` (into a
temporary directory) and the native latent loader (``native/``, optional).
Required: torch with CUDA, numpy, scipy, nvcc and the kernel build; with
``--platform cpu`` (the plain PyTorch path) only torch, numpy and scipy.
Exits 1 when a required one is missing.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import subprocess
import tempfile

DEPS = [("torch", True), ("numpy", True), ("scipy", True),
        ("einops", False), ("tensorboardX", False), ("matplotlib", False),
        ("triton", False)]
PROBE_KERNEL = "w8a8_fused"  # the library the build probe compiles


def _status(ok: bool, required: bool) -> str:
    return "ok" if ok else ("REQUIRED-MISSING" if required
                            else "optional-missing")


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default=None,
                    help="cpu checks what the plain path needs; cuda (the "
                         "default) also the card, nvcc and the kernels")
    args = ap.parse_args(argv)
    if args.platform not in (None, "cpu", "cuda", "gpu"):
        raise SystemExit(f"unknown --platform {args.platform!r}")
    card = args.platform != "cpu"

    print("=" * 60)
    print("jatsr_torch environment check")
    print("=" * 60)
    missing = []

    def report(name, ok, required, detail=""):
        tag = _status(ok, required)
        print(f"  [{tag:>16s}] {name}{' ' + detail if detail else ''}")
        if required and not ok:
            missing.append(name)

    for name, required in DEPS:
        if importlib.util.find_spec(name) is None:
            report(name, False, required)
            continue
        try:
            mod = importlib.import_module(name)
        except Exception as e:  # noqa: BLE001 - reported, the probe goes on
            print(f"  [{'import-error':>16s}] {name}: {e}")
            if required:
                missing.append(name)
            continue
        report(name, True, required, getattr(mod, "__version__", "?"))

    import torch

    cuda = torch.cuda.is_available()
    report("torch CUDA", cuda, card,
           f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)"
           if cuda else f"(torch {torch.__version__} built without it or "
                        f"no card)")
    if cuda:
        try:
            report("card", True, card, _card_line())
        except (OSError, subprocess.SubprocessError) as e:
            report("card", True, card,
                   f"{torch.cuda.get_device_name(0)} (nvidia-smi: {e})")

    from ..ops import _build

    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        nvcc = None
        report("nvcc", False, card, f"({e})")
    if nvcc:
        report("nvcc", True, card, nvcc)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                secs = _build.build_one(PROBE_KERNEL, tmp)
                report("kernel build", True, card,
                       f"{PROBE_KERNEL}.cu in {secs:.1f} s")
            except (RuntimeError, OSError) as e:
                report("kernel build", False, card, str(e)[-400:])
    else:
        report("kernel build", False, card, "(no nvcc)")

    from ..data.native_loader import build_error, is_available

    if is_available():
        report("native latent loader", True, False, "built")
    else:
        report("native latent loader", False, False,
               f"unavailable ({build_error()})")

    if missing:
        print(f"MISSING required deps: {missing}")
        raise SystemExit(1)
    print("environment OK")


if __name__ == "__main__":
    main()
