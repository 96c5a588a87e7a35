"""Train state: the trainable DiT, its AdamW(+clip) optimizer, step, seed.

Port of the JAX package's ``train/state.py``.  The optimizer is optax's
chain, ``clip_by_global_norm(grad_clip)`` then ``adamw`` under the
warmup-cosine schedule, in optax's order of operations (not
``torch.optim.AdamW``):

- clip: ``g -> (g / |g|) * max_norm`` only when ``|g| >= max_norm``, where
  ``|g|`` is the global norm (no epsilon);
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction at the incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``;
- then ``+ weight_decay * param`` and ``* -lr(count)``, the schedule read at
  the count before the increment (so step 0 has lr 0 under warmup);
- ``adam_moments_dtype="bfloat16"`` stores only the first moment in bf16
  (optax's ``mu_dtype``): ``b1 * mu`` is then a bf16 product, as JAX's.

Each leaf runs in its own dtypes, as optax's does under JAX's type
promotion: a Python constant takes the dtype of the array it meets (JAX's
weak typing), two arrays promote to the wider.  With bf16 parameters (and so
bf16 gradients) the clip's global norm is a bf16 sum of each JAX leaf's
squares (bf16 squares summed in fp32, rounded to bf16), the second moment is
bf16, the first ``mu_dtype``, and the new parameter is ``p + u`` in the
promoted dtype, rounded to the parameter's once.  fp32 parameters take the
same steps in fp32.

The port updates parameters and moments in place, which keeps one copy of
each in device memory.  :meth:`TrainState.state_dict` gives the whole state
as tensors keyed by parameter name (what a checkpoint holds), and
:meth:`TrainState.load_state_dict` puts such a dict back bit for bit.

ZeRO-1 (``create_train_state(mesh=..., shard_opt_state=True)``): each data
rank keeps ``mu`` and ``nu`` only for its span of each moment whose leading
dim divides by the data dim (``parallel.mesh.opt_state_plan``; the others
whole on every rank), updates that span of the parameter from the full,
already averaged gradient and the global clip norm, then gathers the
updated spans from every rank.  AdamW is elementwise, so the update is bit
for bit the one without ZeRO-1.  A state dict holds the whole moments
(gathered on every rank; the primary writes them), and loading one keeps
this rank's span: a checkpoint moves between meshes of any data size.

Tensor parallelism (a ``DenseDiT`` built on a mesh whose model dim is past
1): each rank holds its split leaves' spans (``model.split_dims``) and the
moments of what it holds (ZeRO-1 then splits those over the data dim).
The clip norm and the ``grad_norm`` metric sum each split leaf's squares
over the model group and count each replicated leaf once (at bf16, each
split JAX leaf's fp32 partial sums are added over the group and rounded
once, in JAX's leaf order).  A state dict holds whole leaves in the JAX
layout (the split ones gathered over the model group; every rank calls
it), and loading one cuts this rank's leaves, so a checkpoint moves
between one card and any ``(D, M)`` mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import TrainConfig
from ..parallel.distributed import DataGroup, ModelGroup
from ..parallel.mesh import opt_state_plan
from ..utils.device import resolve_device
from .schedule import warmup_cosine


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClipAdamW:
    """``optax.chain(clip_by_global_norm, adamw)`` over a list of tensors."""

    def __init__(self, max_norm: float, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, mu_dtype=torch.float32):
        self.max_norm, self.schedule = max_norm, schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params) -> AdamState:
        """``mu`` in ``mu_dtype``, ``nu`` in each parameter's dtype."""
        return AdamState(0, [torch.zeros_like(p, dtype=self.mu_dtype)
                             for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params, grads, state: AdamState, groups=None,
             g_norm=None) -> None:
        """One update of ``params`` and ``state`` in place.  ``groups``:
        the parameters' indices by JAX leaf in the JAX tree's order
        (:func:`leaf_groups`), the terms of a bf16 clip norm; each
        parameter its own leaf by default.  ``g_norm``: the clip norm where
        ``grads`` are spans of the gradients (ZeRO-1), else computed from
        them."""
        if g_norm is None:
            g_norm = clip_norm(grads, groups)
        keep = g_norm < _weak(self.max_norm, g_norm)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        neg_lr = -float(self.schedule(state.count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, (g / g_norm.to(g.dtype))
                            * _weak(self.max_norm, g))
            m = g * _weak(1 - self.b1, g) + mu * _weak(self.b1, mu)
            n = (g * g) * _weak(1 - self.b2, g) + nu * _weak(self.b2, nu)
            u = (m / _weak(bc1, m)) / (torch.sqrt(n / _weak(bc2, n))
                                       + _weak(self.eps, n))
            mu.copy_(m)
            nu.copy_(n)
            u = u + p * _weak(self.wd, p)
            p.copy_(p + u * _weak(neg_lr, u))
        state.count = count


def _weak(x: float, like: torch.Tensor):
    """The Python constant ``x`` as JAX's weak typing applies it to
    ``like``: in ``like``'s dtype (a Python float where that is fp32, which
    PyTorch rounds to fp32 itself).  A 0-dim CPU tensor: a card's kernel
    takes its value as an argument, with no copy to the card."""
    if like.dtype == torch.float32:
        return x
    return torch.tensor(x, dtype=like.dtype)


def leaf_groups(names) -> List[List[int]]:
    """Parameter names (``DenseDiT``'s) -> their indices grouped by JAX
    leaf (``blocks.<i>.<path>`` stacked over the blocks), the groups in the
    JAX tree's leaf order (dict keys sorted at each level)."""
    groups: Dict[tuple, List[int]] = {}
    for i, name in enumerate(names):
        parts = name.split(".")
        if parts[0] == "blocks":
            parts = ["blocks"] + parts[2:]
        groups.setdefault(tuple(parts), []).append(i)
    return [groups[k] for k in sorted(groups)]


def clip_norm(grads, groups=None, split=None, tp=None) -> torch.Tensor:
    """optax's ``global_norm`` in the gradients' dtype: fp32 gradients give
    :func:`global_norm`; otherwise each JAX leaf's sum of squares (squares
    in the gradient's dtype, summed in fp32 and rounded to it, as ``jnp.sum``
    does), those sums added in the leaves' order in their dtype, then the
    square root.  ``groups`` as :meth:`ClipAdamW.step` takes it.
    ``split`` and ``tp``: which gradients are a rank's span of a leaf split
    over the model group ``tp``; a split leaf's fp32 sum is added over the
    group (one all-reduce for all of them) before its rounding."""
    if all(g.dtype == torch.float32 for g in grads):
        return global_norm(grads, split, tp)
    groups = groups or [[i] for i in range(len(grads))]
    sqs = [sum((grads[i] * grads[i]).sum(dtype=torch.float32)
               for i in group) for group in groups]
    if tp is not None:
        mine = [j for j, group in enumerate(groups) if split[group[0]]]
        if mine:
            whole = tp.sum_f32(torch.stack([sqs[j] for j in mine]))
            for n, j in enumerate(mine):
                sqs[j] = whole[n]
    total = 0
    for group, sq in zip(groups, sqs):
        total = total + sq.to(grads[group[0]].dtype)
    return torch.sqrt(total)


def global_norm(tensors, split=None, tp=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors, fp32.  ``split`` and
    ``tp`` as :func:`clip_norm` takes them: the split tensors' sum is added
    over the group, the others counted once."""
    if tp is None:
        return torch.sqrt(sum((t.float() * t.float()).sum()
                              for t in tensors))
    sq = [(t.float() * t.float()).sum() for t in tensors]
    whole = tp.sum_f32(sum(s for s, m in zip(sq, split) if m))
    return torch.sqrt(sum(s for s, m in zip(sq, split) if not m) + whole)


def make_optimizer(cfg: TrainConfig, total_steps: int) -> ClipAdamW:
    return ClipAdamW(
        cfg.grad_clip, warmup_cosine(cfg.lr, cfg.warmup_steps, total_steps),
        b1=0.9, b2=0.999, eps=1e-8, weight_decay=cfg.weight_decay,
        mu_dtype=getattr(torch, cfg.adam_moments_dtype))


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained state), the optimizer and
    its moments, the step count and the seed the per-step draws come from.
    ``dp`` and ``split``: ZeRO-1's data group and, for each parameter,
    whether this rank holds only its span of the moments (None: whole
    moments).  ``tp`` and ``tp_dims``: the model's tensor-parallel group
    and, for each parameter, the dim the group splits (None: whole)."""

    step: int
    model: torch.nn.Module
    opt_state: AdamState
    seed: int
    tx: ClipAdamW
    dp: Optional[DataGroup] = None
    split: Optional[List[bool]] = None
    tp: Optional[ModelGroup] = None
    tp_dims: Optional[List[Optional[int]]] = None

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def span(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Parameter ``i``'s ``t`` as this rank's moments cover it: its span
        of the leading dim under ZeRO-1 where the leaf splits, else whole
        (a view)."""
        if self.split is None or not self.split[i]:
            return t
        return t.chunk(self.dp.size, 0)[self.dp.rank]

    def _tp_split(self):
        """``(split, tp)`` of :func:`clip_norm` (``(None, None)`` without
        a model group)."""
        if self.tp is None:
            return None, None
        return [d is not None for d in self.tp_dims], self.tp

    def grad_norm(self, grads) -> torch.Tensor:
        """The fp32 global norm of the whole model's gradients."""
        return global_norm(grads, *self._tp_split())

    def apply_gradients(self, grads) -> "TrainState":
        """Clip, AdamW, in place; the step count advances.  Under ZeRO-1
        each rank updates its spans, then the spans are gathered."""
        names = [k for k, _ in self.model.named_parameters()]
        g_norm = clip_norm(grads, leaf_groups(names), *self._tp_split())
        params = self.params
        if self.split is None:
            self.tx.step(params, grads, self.opt_state, g_norm=g_norm)
        else:
            self.tx.step([self.span(p.data, i) for i, p in enumerate(params)],
                         [self.span(g, i) for i, g in enumerate(grads)],
                         self.opt_state, g_norm=g_norm)
            with torch.no_grad():
                for i, p in enumerate(params):
                    if self.split[i]:
                        self._gather(p.data, self.span(p.data, i).clone())
        self.step += 1
        return self

    def _gather(self, full: torch.Tensor, mine: torch.Tensor) -> None:
        """Every rank's span of ``full`` into it, from this rank's
        ``mine``."""
        self.dp.gather(mine, list(full.chunk(self.dp.size, 0)))

    def _whole(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        """The moments whole: under ZeRO-1 the split ones gathered."""
        if self.split is None:
            return list(moments)
        out = []
        for p, m, s in zip(self.params, moments, self.split):
            if s:
                full = torch.empty(p.shape, dtype=m.dtype, device=m.device)
                self._gather(full, m)
                m = full
            out.append(m)
        return out

    def _whole_leaf(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Parameter ``i``'s ``t`` whole: gathered over the model group
        where the group splits it."""
        if self.tp is None or self.tp_dims[i] is None:
            return t
        return self.tp.gather_dim(t, self.tp_dims[i])

    def _local_leaf(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's span of parameter ``i``'s whole ``t`` (a view)."""
        if self.tp is None or self.tp_dims[i] is None:
            return t
        return t.chunk(self.tp.size, self.tp_dims[i])[self.tp.rank]

    def state_dict(self) -> Dict:
        """``{"step", "seed", "params": {name: tensor}, "opt": {"count",
        "mu": {name: tensor}, "nu": {name: tensor}}}``: the tensors are the
        state's own (detached, not copied), but for the moments ZeRO-1
        splits and the leaves a model group splits, which are gathered
        whole (every rank must call this)."""
        names = [k for k, _ in self.model.named_parameters()]

        def whole(ts):
            return {k: self._whole_leaf(t, i)
                    for i, (k, t) in enumerate(zip(names, ts))}

        return {"step": int(self.step), "seed": int(self.seed),
                "params": whole([p.detach() for p in self.params]),
                "opt": {"count": int(self.opt_state.count),
                        "mu": whole(self._whole(self.opt_state.mu)),
                        "nu": whole(self._whole(self.opt_state.nu))}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> "TrainState":
        """Copy a :meth:`state_dict` (from any device; whole leaves) into
        this state in place, this rank's spans of them.  Raises
        ``KeyError`` / ``ValueError`` where its names, shapes or moment
        dtypes are not this state's."""
        named = dict(self.model.named_parameters())
        opt = sd["opt"]
        for group in (sd["params"], opt["mu"], opt["nu"]):
            missing, extra = set(named) - set(group), set(group) - set(named)
            if missing or extra:
                raise KeyError(f"state names differ: missing "
                               f"{sorted(missing)[:4]}, unexpected "
                               f"{sorted(extra)[:4]}")
        cut = self._local_leaf
        pairs = [(dst, src, k) for i, (k, p) in enumerate(named.items())
                 for dst, src in (
                     (p, cut(sd["params"][k], i)),
                     (self.opt_state.mu[i], self.span(cut(opt["mu"][k], i),
                                                      i)),
                     (self.opt_state.nu[i], self.span(cut(opt["nu"][k], i),
                                                      i)))]
        for dst, src, k in pairs:
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{k}: {tuple(src.shape)} {src.dtype} cannot "
                                 f"replace {tuple(dst.shape)} {dst.dtype}")
        for dst, src, _ in pairs:
            dst.copy_(src)
        self.step = int(sd["step"])
        self.seed = int(sd["seed"])
        self.opt_state.count = int(opt["count"])
        return self


def create_train_state(model, cfg: TrainConfig, total_steps: int,
                       sample_batch, seed: int = None,
                       device="cuda", mesh=None,
                       shard_opt_state: bool = None) -> TrainState:
    """The train state of a trainable DiT (``models.dit.DenseDiT``, whose
    parameters are initialised at construction) on ``device``.

    ``sample_batch`` is an (hr, lr) pair ``[B, T, C]``: its channel count
    is checked against the model.  ``mesh`` with ``shard_opt_state``
    (``cfg.shard_opt_state`` by default) splits the moments over the data
    dim (ZeRO-1); without a mesh it does nothing.  A model built on a mesh
    with a model dim past 1 (``DenseDiT(mesh=)``) brings its model group.
    """
    dev = resolve_device(device)
    model.to(dev)
    model.device = dev
    C = model.cfg.input_channels
    for x in sample_batch:
        if x.shape[-1] != C:
            raise ValueError(f"sample batch has {x.shape[-1]} channels, the "
                             f"model takes {C}")
    tx = make_optimizer(cfg, total_steps)
    state = TrainState(step=0, model=model, opt_state=None,
                       seed=cfg.seed if seed is None else seed, tx=tx)
    tp = getattr(model, "tp", None)
    if tp is not None:
        state.tp = tp
        state.tp_dims = [model.split_dims.get(k) for k, _ in
                         model.named_parameters()]
    if shard_opt_state is None:
        shard_opt_state = cfg.shard_opt_state
    if mesh is not None and shard_opt_state:
        state.dp = DataGroup(mesh)
        state.split = opt_state_plan([p.shape for p in state.params],
                                     state.dp.size)
    state.opt_state = tx.init([state.span(p.detach(), i)
                               for i, p in enumerate(state.params)])
    return state
