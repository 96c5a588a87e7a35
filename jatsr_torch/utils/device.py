"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Nothing silently runs on the CPU: without a card, only a caller that asks
for ``device="cpu"`` (the tests) gets the plain PyTorch path.
"""

from __future__ import annotations

import torch


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
