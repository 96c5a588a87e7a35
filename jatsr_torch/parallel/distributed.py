"""Multi-process runs: the process group, each rank's rows, the shared run
name, and the collectives the train step and the pipeline use.

Port of the JAX package's ``parallel/distributed.py``.  JAX joins every
host into one runtime and drives a mesh from one process a host; PyTorch's
idiom is one process a card, launched by ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N``), which exports ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE``.  :func:`init_distributed` joins from those (or from
explicit arguments) and sets the rank's card.

What each process owns: its card, and its span of every global batch
(:func:`process_batch_slice`: the global order of sample indices is the same
on every rank, crops and shuffles being pure functions of (seed, epoch,
index)), and, on a model axis past 1, its share of each block projection.
Gradients, validation metrics and sampled rows meet in :class:`DataGroup`'s
collectives, a tensor-parallel forward's row maxima, int32 partial products,
row-parallel sums and AdaLN columns in :class:`ModelGroup`'s, whose
:meth:`~ModelGroup.reduce_out` is Megatron's g under autograd (f is folded
into each column-parallel product's backward, ``models/dit.py``).  Both use only ``all_reduce``,
``broadcast`` and the list form of ``all_gather``: the three that gloo
also takes on CUDA tensors, so that two ranks may share one card over gloo
(NCCL refuses that).  A collective a backend refuses raises; nothing is
copied to the host behind the caller's back.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (DATA_AXIS, MODEL_AXIS, data_rank, data_size,
                   default_backend, model_rank, model_size)


def card_of(local_rank: int, local_world: int, n_cards: int,
            backend: str) -> int:
    """The card of local rank ``local_rank`` of ``local_world`` on a host
    with ``n_cards``: ``local_rank mod n_cards``.  Raises ``RuntimeError``
    where NCCL would put two local ranks on one card (NCCL refuses a
    duplicate GPU): share a card over gloo, and say so."""
    if n_cards < 1:
        raise RuntimeError("no CUDA card for a CUDA rank")
    if backend == "nccl" and local_world > n_cards:
        raise RuntimeError(
            f"{local_world} local ranks on {n_cards} card(s) under NCCL: "
            f"NCCL refuses two ranks on one GPU (duplicate GPU); launch at "
            f"most {n_cards} ranks a host, or pass backend='gloo' to share "
            f"a card")
    return local_rank % n_cards


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> None:
    """Join the process group.

    Arguments left None come from torchrun's environment (``MASTER_ADDR``
    and ``MASTER_PORT`` give ``env://``; ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).  A no-op where the group exists
    already or where nothing marks a multi-process launch.  ``backend``:
    NCCL for ``device="cuda"``, gloo for ``"cpu"`` by default; on a card
    the rank's card is set from its local rank (:func:`card_of`, which
    raises where NCCL would share one)."""
    if dist.is_initialized():
        return
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None or world_size is None:
        return  # one process: nothing to join
    rank = 0 if rank is None else rank
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        from ..utils.device import resolve_device

        resolve_device(dev)
        torch.cuda.set_device(card_of(local_rank, local_world,
                                      torch.cuda.device_count(), backend))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """Rank 0 (or no process group): the process that writes files."""
    return world()[0] == 0


def process_batch_slice(global_batch: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> slice:
    """This process's contiguous span of the global batch: rows
    ``[p B / P, (p + 1) B / P)``."""
    p, n = world()
    p = p if process_index is None else process_index
    n = n if process_count is None else process_count
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} must divide by process count {n}")
    per = global_batch // n
    return slice(p * per, (p + 1) * per)


def put_global_batch(mesh, *locals_, global_batch: Optional[int] = None,
                     device=None) -> Tuple[torch.Tensor, ...]:
    """This rank's rows ``[B / D, ...]`` (numpy or tensors) -> tensors on its
    card (``device``, the current card by default).  The global batch is
    never assembled: each rank keeps its span, and the step's collectives
    join the ranks.  ``global_batch`` is checked against the rows a rank
    holds."""
    D = data_size(mesh)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    out = []
    for x in locals_:
        if global_batch is not None and x.shape[0] * D != global_batch:
            raise ValueError(f"{x.shape[0]} rows a rank x {D} ranks != "
                             f"global batch {global_batch}")
        out.append(torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device))
    return tuple(out)


def _collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the card
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shared_run_name(name: str) -> str:
    """Rank 0's run-directory name on every rank (timestamp names can
    differ by a tick between processes): its bytes broadcast."""
    if world()[1] == 1:
        return name
    buf = np.zeros(64, np.uint8)
    raw = name.encode()[:64]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    t = torch.from_numpy(buf).to(_collective_device())
    dist.broadcast(t, src=0)
    return bytes(t.cpu().numpy()).rstrip(b"\x00").decode()


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class DataGroup:
    """The data dim of a mesh as the train step, the optimizer and the
    pipeline use it: ``size`` ranks, this one ``rank``, the collectives on
    ``mesh.get_group("data")``.  :meth:`of` gives None without a mesh, so
    that one process keeps the single-card code path."""

    def __init__(self, mesh):
        self.size = data_size(mesh)
        self.rank = data_rank(mesh)
        self.group = mesh.get_group(DATA_AXIS)

    @classmethod
    def of(cls, mesh) -> Optional["DataGroup"]:
        return None if mesh is None else cls(mesh)

    def rows(self, global_batch: int) -> slice:
        return process_batch_slice(global_batch, self.rank, self.size)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place: the sum over the ranks, the same bits
        on every rank."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, mine: torch.Tensor, out: List[torch.Tensor]) -> None:
        """Every rank's ``mine`` into ``out`` (one tensor a rank, in rank
        order; ``out[self.rank]`` may not alias ``mine``)."""
        dist.all_gather(out, mine, group=self.group)

    def gather_rows(self, mine: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (equal counts), concatenated in rank order."""
        out = [torch.empty_like(mine) for _ in range(self.size)]
        self.gather(mine.contiguous(), out)
        return torch.cat(out)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Data rank ``src``'s ``t`` on every rank, in place."""
        dist.broadcast(t, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        return t

    def mean(self, values: List[torch.Tensor], numel: int
             ) -> List[torch.Tensor]:
        """Global means: each of ``values`` is a rank's sum over ``numel``
        of its elements (every rank the same count); one all-reduce for
        all of them."""
        sums = self.sum_(torch.stack([v.float() for v in values]))
        return list(sums / (numel * self.size))


class ModelGroup:
    """The model dim of a mesh as a tensor-parallel forward uses it: ``size``
    ranks, this one ``rank``, the collectives on ``mesh.get_group("model")``
    (the ranks that share a data rank).  :meth:`of` gives None without a
    mesh or at a model dim of 1, so that one rank keeps the one-card code
    path."""

    def __init__(self, mesh):
        self.size = model_size(mesh)
        self.rank = model_rank(mesh)
        self.group = mesh.get_group(MODEL_AXIS)

    @classmethod
    def of(cls, mesh) -> Optional["ModelGroup"]:
        return None if model_size(mesh) == 1 else cls(mesh)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` (fp32 row maxima) in place: the max over the
        ranks, exact in any order."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` (int32 partial products) in place: the sum over
        the ranks, exact in any order."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather_cols(self, mine: torch.Tensor) -> torch.Tensor:
        """Every rank's ``mine`` (equal shapes) concatenated on the last dim
        in rank order: a column-parallel output made whole.  Under autograd
        the backward keeps this rank's columns of the cotangent (which every
        rank holds whole and equal)."""
        return _GatherCols.apply(mine, self)

    def gather_dim(self, mine: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``mine`` (equal shapes) concatenated on ``dim`` in
        rank order (no autograd: a split leaf made whole)."""
        out = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(out, mine.contiguous(), group=self.group)
        return torch.cat(out, dim=dim)

    def sum_f32(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh fp32 tensor: ``t`` summed over the ranks in fp32 (the
        same bits on every rank)."""
        s = t.to(torch.float32, copy=True)
        dist.all_reduce(s, group=self.group)
        return s

    def reduce_out(self, partial: torch.Tensor) -> torch.Tensor:
        """Megatron's g, at the output of a row-parallel product: the
        ranks' partial products (fp32, unrounded) summed over the ranks in
        fp32 (a fresh tensor); its backward is the identity."""
        return _ReduceOut.apply(partial, self)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, group):
        return group.sum_f32(partial)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mine, group):
        ctx.group, ctx.n = group, mine.shape[-1]
        return group.gather_dim(mine, -1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def broadcast_tree(tree, src: int = 0):
    """A nested dict of tensors or numpy arrays -> the same tree of CPU
    tensors holding global rank ``src``'s values, leaf by leaf over the
    whole world (the default group's device carries them); the tree as
    tensors where there is one process."""
    def leaf(x):
        t = torch.as_tensor(x)
        if world()[1] == 1:
            return t
        buf = t.to(_collective_device(), copy=True).contiguous()
        dist.broadcast(buf, src=src)
        return buf.cpu()

    return {k: broadcast_tree(v, src) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}
