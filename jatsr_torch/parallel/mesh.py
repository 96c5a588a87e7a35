"""The (data, model) device mesh, the tensor-parallel rule table and the
ZeRO-1 plan.

Port of the JAX package's ``parallel/mesh.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group, one
process a card (``torchrun``), with dims named ``"data"`` and ``"model"``:

- ``data``: the batch.  Each rank holds one contiguous span of every global
  batch (:func:`batch_rows`), the train step all-reduces the gradients over
  ``mesh.get_group("data")``, and the pipeline gathers the sampled rows over
  it;
- ``model``: tensor parallelism over attention heads, the MLP width and the
  AdaLN width.  Not ported: a mesh whose model dim is past 1 raises
  ``NotImplementedError`` (ROADMAP section A item 8(b)).  The rule table
  below is what that slice places by; at model 1 every leaf is replicated.

A mesh of one card needs no launcher: :func:`make_mesh` joins a world of
one where no process group exists.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TENSOR_PARALLEL = ("a model axis past 1 (tensor parallelism) is not ported "
                   "yet: ROADMAP section A item 8(b)")


def default_backend(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(data: int = -1, model: int = 1, device="cuda"):
    """A ``(data, model)`` mesh over the process group's ranks; ``data=-1``
    takes every rank the model dim leaves.  Raises ``NotImplementedError``
    for ``model > 1`` and ``ValueError`` where ``data * model`` is not the
    world size.  Without a process group a mesh of one joins a world of one
    (an in-process store, the device's backend).  ``device``: ``"cuda"``
    (default; each rank's current card) or an explicit ``"cpu"``."""
    if model > 1:
        raise NotImplementedError(f"--mesh {data} {model}: {TENSOR_PARALLEL}")
    if model < 1:
        raise ValueError(f"model axis {model} must be at least 1")
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if world % model:
            raise ValueError(f"{world} processes do not split over a model "
                             f"axis of {model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if not dist.is_initialized():
        dist.init_process_group(default_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_size(mesh) -> int:
    """The mesh's data dim (1 without a mesh); raises for a model dim past
    1."""
    if mesh is None:
        return 1
    if mesh.size(1) > 1:
        raise NotImplementedError(f"a {mesh.size(0)}x{mesh.size(1)} mesh: "
                                  f"{TENSOR_PARALLEL}")
    return mesh.size(0)


def data_rank(mesh) -> int:
    """This process's index on the data dim (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def batch_rows(mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch: the span the JAX package's
    ``batch_sharding`` places on its device."""
    from .distributed import process_batch_slice

    return process_batch_slice(global_batch, data_rank(mesh), data_size(mesh))


# The tensor-parallel rules of the JAX package, by the projection's kind and
# then the leaf's name.  Paths are the JAX tree's, "/"-joined, with the
# stacked ``blocks`` carrying a leading depth dim; a ``kernel_scale`` always
# follows its kernel's output-dim split, its size-1 input dim never split.
# Column-parallel (output dim over the model axis): q/k/v and the fused
# qkv, mlp_in, adaln.  Row-parallel (input dim over the model axis; output,
# scales and biases replicated): out_proj, mlp_out.
_COL_PAT = re.compile(
    r"blocks/(attn/(qkv_proj|q_proj|k_proj|v_proj)|mlp_in|adaln)(/|$)")
_ROW_PAT = re.compile(r"blocks/(attn/out_proj|mlp_out)(/|$)")

Spec = Tuple[Optional[str], ...]  # one mesh axis name (or None) a dim


def spec_for(path: str, ndim: int) -> Spec:
    """The partition spec of the leaf at ``path`` with ``ndim`` dims: one
    entry a dim, the mesh axis it splits over or None; ``()`` replicates."""
    leaf = path.rsplit("/", 1)[-1]
    if _COL_PAT.search(path):
        if leaf in ("kernel", "kernel_q", "kernel_scale"):
            spec: Spec = (None, None, MODEL_AXIS)  # [depth, K (or 1), N]
        elif leaf == "bias":
            spec = (None, MODEL_AXIS)
        else:
            return ()
    elif _ROW_PAT.search(path):
        if leaf in ("kernel", "kernel_q"):
            spec = (None, MODEL_AXIS, None)  # [depth, K, N]: split K
        else:
            return ()  # per-output-column scale and bias
    else:
        return ()  # patch embed, t-MLP, final layer
    if len(spec) == ndim:
        return spec
    if len(spec) == ndim + 1 and spec[0] is None:
        return spec[1:]  # an unstacked leaf: no depth dim
    return ()


def divisible(spec: Spec, shape: Sequence[int], axis_sizes: Dict[str, int]
              ) -> bool:
    """Every split dim divides by its axis's size (a width that does not
    is replicated rather than placed unevenly)."""
    for dim, ax in zip(shape, spec):
        if ax is not None and (dim == 0 or dim % axis_sizes[ax]):
            return False
    return True


def _leaves(tree, prefix="") -> List[Tuple[str, object]]:
    """``(path, leaf)`` of a nested dict, paths "/"-joined, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        out += _leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def param_specs(tree, data: int = 1, model: int = 1) -> Dict[str, Spec]:
    """The tensor-parallel spec of every leaf of a JAX-layout parameter tree
    (nested dicts of arrays or tensors: the dense tree or the int8_static
    one), keyed by "/"-joined path; a leaf whose split does not divide by
    ``model`` replicated.  Equal to the JAX package's ``param_shardings``
    on a ``(data, model)`` mesh."""
    sizes = {DATA_AXIS: data, MODEL_AXIS: model}
    out = {}
    for path, leaf in _leaves(tree):
        shape = tuple(leaf.shape)
        spec = spec_for(path, len(shape))
        out[path] = spec if divisible(spec, shape, sizes) else ()
    return out


def opt_state_plan(shapes: Sequence[Sequence[int]], data: int) -> List[bool]:
    """ZeRO-1 over the data dim: for each moment leaf (the parameters'
    shapes), whether it splits on its leading dim into ``data`` equal
    spans (that dim divides by ``data``) or stays whole on every rank."""
    return [len(s) >= 1 and s[0] > 0 and s[0] % data == 0 for s in shapes]
