"""PyTorch/CUDA port of the audio super-resolution system.

Sits beside the JAX package and is held against it module by module
(``tests/test_torch_*.py``).  Imports ``torch`` and numpy only; the
hand-written Hopper kernels under ``ops/csrc/`` are built at first use.
"""

from .utils.device import settle_cpu_math

settle_cpu_math()
