"""The port's plain (CPU) paths give the same bits in every process.

ATen hands a contiguous fp32 tensor's tanh, exp, erf, sin... to MKL's vector
math library (VML) in chunks of 2048 on its OpenMP threads, and VML picks a
function's kernel at the function's first call.  Where that first call is a
multi-threaded one, a thread can run its chunks through the low-accuracy
kernel: tanh off by up to 5e-5 on a few chunks, in a few processes in a
hundred (most often with JAX busy in the same process).  That made the
plain version of B5 (``dense_gelu_quant_plain``) differ between processes.
Importing the port first calls each such op once on one thread
(``utils.device.settle_cpu_math``).
"""

import subprocess
import sys
from pathlib import Path

import torch

from jatsr_torch.utils import device

ROOT = Path(__file__).resolve().parents[1]

_FIRST_CALLS = """
import numpy as np, torch
import jatsr_torch
torch.set_num_threads(8)
u = np.random.default_rng(0).uniform(-4, 4, 51200).astype(np.float32)
x = torch.from_numpy(u)
for name, ref in (("tanh", np.tanh), ("exp", np.exp), ("sin", np.sin)):
    got = getattr(torch, name)(x).numpy().astype(np.float64)
    want = ref(u.astype(np.float64))
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() < 4 * 2.0 ** -24, (name, err.max())
print("ok")
"""


def test_settle_calls_every_vml_op_on_this_thread(monkeypatch):
    called = []
    for name in device._VML_OPS:
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda x, _f=fn, _n=name: (
            called.append(_n), _f(x))[1])
    device.settle_cpu_math()
    assert called == list(device._VML_OPS)
    assert {"tanh", "exp", "erf", "sin"} <= set(called)


def test_first_multithreaded_calls_after_import_are_accurate():
    """In a fresh process, after ``import jatsr_torch``: the first
    multi-threaded tanh, exp and sin over 51200 values are within 4 ulps of
    float64 on every chunk."""
    out = subprocess.run([sys.executable, "-c", _FIRST_CALLS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
