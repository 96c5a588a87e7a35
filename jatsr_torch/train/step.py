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
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs import LossConfig, TrainConfig
from ..losses import total_training_loss
from ..sampling.flow import flow_interpolate, u_shaped
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
    """The step's random draws, from ``(state.seed, state.step)``."""
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


def make_train_step(loss_cfg: LossConfig, train_cfg: TrainConfig,
                    normalizer: Normalizer):
    """``step(state, hr, lr, draws=None) -> (state, metrics)``; the state's
    parameters and moments are updated in place.  Metrics are 0-dim fp32
    tensors on the state's device."""

    def step_fn(state: TrainState, hr, lr, draws: Optional[dict] = None
                ) -> tuple:
        model = state.model
        dev = model.device
        hr = hr.to(dev, torch.float32)
        lr = lr.to(dev, torch.float32)
        d = draws if draws is not None else step_draws(state, hr.shape,
                                                       train_cfg)
        d = {k: v if k == "layer_seeds" else _on(dev, v)
             for k, v in d.items()}
        B = hr.shape[0]
        hr_norm = normalizer.norm_hr(hr)
        lr_norm = normalizer.norm_lr(lr)
        lr_orig = lr_norm  # pre-noise LR for the consistency loss

        cond_noise_std = torch.zeros((), dtype=torch.float32, device=dev)
        if train_cfg.condition_noise_ratio > 0:
            batch_std = (torch.clamp(lr_norm.std(correction=0), 0.5, 2.0)
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
        mb = B // A
        if mb * A != B:
            raise ValueError(f"batch {B} does not split into {A} micro-batches")
        params = state.params
        for p in params:
            p.grad = None
        losses, ms, preds = [], [], []
        for a in range(A):
            sl = slice(a * mb, (a + 1) * mb)
            pred = model(z_t[sl], t[sl], lr_norm[sl], deterministic=False,
                         layer_seeds=d["layer_seeds"])
            loss, m = total_training_loss(pred, hr_norm[sl], lr_orig[sl],
                                          loss_cfg)
            loss.backward()
            losses.append(loss.detach())
            ms.append({k: v.detach() for k, v in m.items()})
            preds.append(pred.detach())
        grads = [p.grad for p in params]
        if A > 1:
            grads = [g / A for g in grads]
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        pred = torch.cat(preds)
        grad_norm = global_norm(grads)
        state.apply_gradients(grads)
        for p in params:
            p.grad = None

        signal_power = (hr_norm ** 2).mean()
        noise_power = ((pred - hr_norm) ** 2).mean()
        metrics.update(
            grad_norm=grad_norm,
            snr_db=10.0 * torch.log10(signal_power / (noise_power + 1e-8)),
            pred_mean=pred.mean(), pred_std=pred.std(correction=0),
            cond_noise_std=cond_noise_std)
        return state, metrics

    return step_fn


def make_eval_step(loss_cfg: LossConfig, normalizer: Normalizer):
    """``eval(state, hr, lr, seed=0, draws=None) -> metrics``: uniform t,
    no augmentation, the deterministic model.  ``draws`` may give ``t``
    ``[B]`` and ``noise`` ``[B, T, C]``."""

    @torch.no_grad()
    def eval_fn(state: TrainState, hr, lr, seed: int = 0,
                draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = model.device
        hr = hr.to(dev, torch.float32)
        lr = lr.to(dev, torch.float32)
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            draws = {"t": torch.rand((hr.shape[0],), generator=gen,
                                     device=dev),
                     "noise": torch.randn(hr.shape, generator=gen,
                                          device=dev)}
        hr_norm = normalizer.norm_hr(hr)
        lr_norm = normalizer.norm_lr(lr)
        t = _on(dev, draws["t"])
        z_t = flow_interpolate(hr_norm, _on(dev, draws["noise"]), t)
        pred = model(z_t, t, lr_norm)
        _, metrics = total_training_loss(pred, hr_norm, lr_norm, loss_cfg)
        return dict(metrics)

    return eval_fn
