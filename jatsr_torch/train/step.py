"""Latent normalization and the train / eval steps.

Port of the JAX package's ``train/step.py``.  One train step: normalization,
adaptive condition noise, sample-level CFG dropout (after the noise, so the
null condition stays exactly zero), U-shaped t, flow interpolation, the DiT
forward on its training path, the loss stack, backward (``grad_accum_steps``
micro-batches, grads averaged), global-norm clip and AdamW, and the logged
metrics.

The step's random draws come from a generator made from ``(seed, step)`` on
the step's device, and the per-(step, layer) seeds of the DiT's dropout
(B10's hash, the blocks' masks) from a host generator made from the same
pair, before the forward.  ``draws=`` replaces them (tests feed the JAX
step's own draws): ``noise`` ``[B, T, C]``, ``u`` ``[B]`` (the uniforms of
the U-shaped t), ``cond_noise`` ``[B, T, C]``, ``cfg_u`` ``[B, 1, 1]``,
``layer_seeds`` (``depth`` ints).

Under a mesh (``mesh=``, a ``(D, 1)`` :func:`~jatsr_torch.parallel.make_mesh`)
each of D processes holds one contiguous span of the global batch, and the
step is the single-card step on the global batch up to rounding (float sums
in another order; a rank's bf16 weight-gradient sums rounded before the
all-reduce adds them):

- every draw is the global batch's, of which the rank keeps its rows
  (``draws=`` then gives the global batch's draws); the DiT's dropout and
  drop-path masks and B10's dropout hash are keyed by the row's place in
  its global micro-batch (``DenseDiT(rows=...)``, ``b0``);
- the batch statistics (the adaptive condition noise's std, the logged
  diagnostics and loss terms) are the global batch's, by all-reduce;
- the rank's rows are cut at the global micro-batch boundaries (micro-batch
  k is global rows ``[k mb, (k + 1) mb)``, as JAX's ``lax.scan`` takes
  them); each piece's loss, a mean over its rows, is weighted by its share
  of a micro-batch, so that every row's gradient counts ``1 / B`` as on one
  card, whatever the grouping (the losses are means of per-row terms);
- the gradients are all-reduced as a mean over ``"data"`` before the clip,
  so every rank applies one update (``TrainState`` splits the moments under
  ZeRO-1).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs import LossConfig, TrainConfig
from ..losses import total_training_loss
from ..sampling.flow import flow_interpolate, u_shaped
from ..parallel.distributed import DataGroup
from ..parallel.mesh import check_no_model_axis
from ..utils.device import resolve_device
from .state import TrainState, global_norm


class Normalizer:
    """Per-channel latent normalization from global stats ``[C]``."""

    def __init__(self, hr_mean, hr_std, lr_mean, lr_std, device="cuda"):
        dev = resolve_device(device)

        def as_row(v):
            return torch.as_tensor(v, dtype=torch.float32).to(dev) \
                .reshape(1, 1, -1)

        self.hr_mean, self.hr_std = as_row(hr_mean), as_row(hr_std)
        self.lr_mean, self.lr_std = as_row(lr_mean), as_row(lr_std)

    def norm_hr(self, x):
        return (x - self.hr_mean) / self.hr_std

    def norm_lr(self, x):
        return (x - self.lr_mean) / self.lr_std

    def denorm_hr(self, x):
        return x * self.hr_std + self.hr_mean


def _on(dev, x) -> torch.Tensor:
    """A draw (numpy array or tensor) as an fp32 tensor on ``dev``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(dev, torch.float32)


def step_draws(state: TrainState, shape, train_cfg: TrainConfig) -> dict:
    """The step's random draws, from ``(state.seed, state.step)``, for a
    batch of ``shape`` (under a mesh, the global batch's)."""
    dev = state.model.device
    key = ((state.seed & 0xFFFFFFFF) << 32) | (state.step & 0xFFFFFFFF)
    gen = torch.Generator(device=dev).manual_seed(key)
    B = shape[0]
    draws = {"noise": torch.randn(shape, generator=gen, device=dev),
             "u": torch.rand((B,), generator=gen, device=dev)}
    if train_cfg.condition_noise_ratio > 0:
        draws["cond_noise"] = torch.randn(shape, generator=gen, device=dev)
    if train_cfg.cfg_dropout_prob > 0:
        draws["cfg_u"] = torch.rand((B, 1, 1), generator=gen, device=dev)
    host = np.random.default_rng([state.seed & 0xFFFFFFFF, state.step])
    draws["layer_seeds"] = [int(s) for s in host.integers(
        -2 ** 31, 2 ** 31, state.model.cfg.depth)]
    return draws


def _std(x, dp: Optional[DataGroup]) -> torch.Tensor:
    """The global batch's population std of ``x`` (this rank's rows)."""
    if dp is None or dp.size == 1:
        return x.std(correction=0)
    m = dp.mean([x.sum()], x.numel())[0]
    return torch.sqrt(dp.mean([((x - m) ** 2).sum()], x.numel())[0])


def micro_pieces(rows: slice, accum: int, global_batch: int, ranks: int):
    """A rank's rows ``rows`` of the global batch cut at the micro-batch
    boundaries: ``[(local slice, draw rows, weight)]``, where the draw rows
    are None for a whole micro-batch, else ``(offset in the micro-batch,
    micro-batch size)``, and the weight is the piece's rows times ``ranks``
    over the micro-batch size (1 where each rank holds one equal share)."""
    mb = global_batch // accum
    out = []
    for k in range(accum):
        lo, hi = max(k * mb, rows.start), min((k + 1) * mb, rows.stop)
        if lo < hi:
            sub = None if hi - lo == mb else (lo - k * mb, mb)
            out.append((slice(lo - rows.start, hi - rows.start), sub,
                        (hi - lo) * ranks / mb))
    return out


def make_train_step(loss_cfg: LossConfig, train_cfg: TrainConfig,
                    normalizer: Normalizer, mesh=None):
    """``step(state, hr, lr, draws=None) -> (state, metrics)``; the state's
    parameters and moments are updated in place.  Metrics are 0-dim fp32
    tensors on the state's device (the global batch's under a mesh, the
    same on every rank)."""
    check_no_model_axis(mesh, "the train step")
    dp = DataGroup.of(mesh)
    D = 1 if dp is None else dp.size

    def step_fn(state: TrainState, hr, lr, draws: Optional[dict] = None
                ) -> tuple:
        model = state.model
        dev = model.device
        hr = hr.to(dev, torch.float32)
        lr = lr.to(dev, torch.float32)
        B = hr.shape[0]
        Bg = B * D
        rows = slice(0, B) if dp is None else dp.rows(Bg)
        d = draws if draws is not None else step_draws(
            state, (Bg,) + tuple(hr.shape[1:]), train_cfg)
        d = {k: v if k == "layer_seeds" else _on(dev, v)[rows]
             for k, v in d.items()}
        hr_norm = normalizer.norm_hr(hr)
        lr_norm = normalizer.norm_lr(lr)
        lr_orig = lr_norm  # pre-noise LR for the consistency loss

        cond_noise_std = torch.zeros((), dtype=torch.float32, device=dev)
        if train_cfg.condition_noise_ratio > 0:
            batch_std = (torch.clamp(_std(lr_norm, dp), 0.5, 2.0)
                         if train_cfg.use_adaptive_noise
                         else torch.ones((), device=dev))
            cond_noise_std = train_cfg.condition_noise_ratio * batch_std
            lr_norm = lr_norm + cond_noise_std * d["cond_noise"]
        if train_cfg.cfg_dropout_prob > 0:
            keep = d["cfg_u"] >= train_cfg.cfg_dropout_prob
            lr_norm = lr_norm * keep.to(lr_norm.dtype)
        t = u_shaped(d["u"], train_cfg.timestep_alpha)
        z_t = flow_interpolate(hr_norm, d["noise"], t)

        A = max(train_cfg.grad_accum_steps, 1)
        if (Bg // A) * A != Bg:
            raise ValueError(f"batch {Bg} does not split into {A} "
                             f"micro-batches")
        params = state.params
        for p in params:
            p.grad = None
        ms, ws, preds = [], [], []
        for sl, sub, w in micro_pieces(rows, A, Bg, D):
            pred = model(z_t[sl], t[sl], lr_norm[sl], deterministic=False,
                         layer_seeds=d["layer_seeds"], rows=sub)
            loss, m = total_training_loss(pred, hr_norm[sl], lr_orig[sl],
                                          loss_cfg)
            (loss if w == 1.0 else loss * w).backward()
            ms.append({k: v.detach() for k, v in m.items()})
            ws.append(w)
            preds.append(pred.detach())
        grads = [p.grad for p in params]
        if dp is not None:
            for g in grads:
                dp.sum_(g)
        if A * D > 1:
            grads = [g / (A * D) for g in grads]
        pred = torch.cat(preds)
        if D == 1:
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
            signal_power = (hr_norm ** 2).mean()
            noise_power = ((pred - hr_norm) ** 2).mean()
            pred_mean, pred_std = pred.mean(), pred.std(correction=0)
        else:
            keys = list(ms[0])
            local = [sum(w * m[k] for w, m in zip(ws, ms)) for k in keys]
            n = pred.numel()
            *means, signal_power, noise_power, pred_mean = dp.mean(
                local, A) + dp.mean([(hr_norm ** 2).sum(),
                                     ((pred - hr_norm) ** 2).sum(),
                                     pred.sum()], n)
            metrics = dict(zip(keys, means))
            pred_std = torch.sqrt(dp.mean([((pred - pred_mean) ** 2).sum()],
                                          n)[0])
        grad_norm = global_norm(grads)
        state.apply_gradients(grads)
        for p in params:
            p.grad = None

        metrics.update(
            grad_norm=grad_norm,
            snr_db=10.0 * torch.log10(signal_power / (noise_power + 1e-8)),
            pred_mean=pred_mean, pred_std=pred_std,
            cond_noise_std=cond_noise_std)
        return state, metrics

    return step_fn


def make_eval_step(loss_cfg: LossConfig, normalizer: Normalizer, mesh=None):
    """``eval(state, hr, lr, seed=0, draws=None) -> metrics``: uniform t,
    no augmentation, the deterministic model.  ``draws`` may give ``t``
    ``[B]`` and ``noise`` ``[B, T, C]``.  Under a mesh the draws are the
    global batch's (this rank keeps its rows) and the metrics the global
    batch's means, the same on every rank."""
    dp = DataGroup.of(mesh)
    D = 1 if dp is None else dp.size

    @torch.no_grad()
    def eval_fn(state: TrainState, hr, lr, seed: int = 0,
                draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = model.device
        hr = hr.to(dev, torch.float32)
        lr = lr.to(dev, torch.float32)
        Bg = hr.shape[0] * D
        rows = slice(0, hr.shape[0]) if dp is None else dp.rows(Bg)
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            draws = {"t": torch.rand((Bg,), generator=gen, device=dev),
                     "noise": torch.randn((Bg,) + tuple(hr.shape[1:]),
                                          generator=gen, device=dev)}
        hr_norm = normalizer.norm_hr(hr)
        lr_norm = normalizer.norm_lr(lr)
        t = _on(dev, draws["t"])[rows]
        z_t = flow_interpolate(hr_norm, _on(dev, draws["noise"])[rows], t)
        pred = model(z_t, t, lr_norm)
        _, metrics = total_training_loss(pred, hr_norm, lr_norm, loss_cfg)
        if D == 1:
            return dict(metrics)
        keys = list(metrics)
        return dict(zip(keys, dp.mean([metrics[k] for k in keys], 1)))

    return eval_fn
