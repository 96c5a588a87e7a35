"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Nothing silently runs on the CPU: without a card, only a caller that asks
for ``device="cpu"`` (the tests) gets the plain PyTorch path.
"""

from __future__ import annotations

import torch

# The ATen unary ops that hand a contiguous fp32 CPU tensor to MKL's vector
# math library (VML), in chunks of 2048 on the OpenMP threads.
_VML_OPS = ("acos", "asin", "atan", "cos", "cosh", "erf", "erfc", "erfinv",
            "exp", "expm1", "lgamma", "log", "log10", "log1p", "sin", "sinh",
            "sqrt", "tan", "tanh", "trunc")


def settle_cpu_math() -> None:
    """Call each VML-backed op once, on one element, on this thread.

    VML picks each function's kernel at its first call, and that choice is
    not thread-safe: where the first call of a function is a multi-threaded
    one, a thread can run its chunks through the low-accuracy ("EP")
    kernel (tanh off by up to 5e-5), in a few processes in a hundred
    under load.  One single-threaded call first makes every later call
    take the accurate kernel, so the plain (CPU) paths give the same bits
    in every process.
    """
    x = torch.full((1,), 0.5)
    for name in _VML_OPS:
        getattr(torch, name)(x)


def resolve_device(device="cuda") -> torch.device:
    """Check ``device`` and return it as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is absent.  On a
    CUDA device it also turns TF32 off for matmuls and cuDNN convolutions:
    the port's fp32 products (time MLP, DAC decode convolutions) must match
    the JAX package's fp32 numerics, and cuDNN's default TF32 conv differs
    at about 1e-3 relative.  And it turns off cuBLAS's reduced-precision
    (bf16) reductions in bf16 products: the JAX package's bf16 products
    (the trainable DiT's projections, the serving AdaLN and head) sum in
    fp32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev
