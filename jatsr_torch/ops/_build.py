"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points and is compiled by
``nvcc`` into ``build/lib<name>.so``, then loaded with ``ctypes``.  No
PyTorch headers are included, so a build takes seconds.  The first call of
:func:`load` builds every source at once, one ``nvcc`` process per file,
all started together, unless ``build/`` already holds every library, each
newer than every source and header (so the ranks and subprocesses of one
run load the first process's build instead of racing to rebuild it).  A
failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers pass that code to :func:`check`, which raises on non-zero.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(srcs, out_dir: Path) -> float:
    """Compile each source into ``out_dir/lib<stem>.so``, one ``nvcc`` per
    file, all started together; each compiler's output is kept in
    ``out_dir/<stem>.log``.  Returns the seconds it took; raises with the
    compiler's output if any build fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        out = out_dir / f"lib{src.stem}.so"
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.so"
        log = open(out_dir / f"{src.stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def build_one(name: str, out_dir) -> float:
    """Compile ``csrc/<name>.cu`` alone into ``out_dir`` (the environment
    check's probe: nothing is loaded).  Returns the seconds it took."""
    return _compile([CSRC / f"{name}.cu"], Path(out_dir))


def _built(srcs) -> bool:
    """``build/`` holds each source's library, newer than every file of
    ``csrc/``."""
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    libs = [BUILD / f"lib{s.stem}.so" for s in srcs]
    return all(lib.exists() and lib.stat().st_mtime >= newest for lib in libs)


def _build_all() -> None:
    """Compile every ``csrc/*.cu`` in parallel into ``build/``, unless it is
    built already (:func:`_built`)."""
    global build_seconds
    srcs = sorted(CSRC.glob("*.cu"))
    if not _built(srcs):
        build_seconds = _compile(srcs, BUILD)


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` register and spill report)."""
    return (BUILD / f"{name}.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    with _lock:
        if not _libs:
            _build_all()
            for src in sorted(CSRC.glob("*.cu")):
                _libs[src.stem] = ctypes.CDLL(str(BUILD / f"lib{src.stem}.so"))
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        lib.jt_error_string.restype = ctypes.c_char_p
        lib.jt_error_string.argtypes = [ctypes.c_int]
        msg = lib.jt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def aligned(t):
    """``t`` contiguous, with the 16-byte alignment the kernels' vector
    loads need (a view into the middle of a buffer may lack it)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
