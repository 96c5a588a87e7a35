"""Flow-matching math and the ODE sampler with classifier-free guidance.

Port of the JAX package's ``sampling/flow.py``: the training draws
(``flow_interpolate``, ``u_shaped_timesteps``) and ``FlowSampler``:

- x-prediction Euler or Heun steps with the ``1/(1 - t + eps)`` velocity
  guard; Heun's second velocity is taken at ``t_next`` with the table at
  ``i + 1``, and an interval with ``t_next >= t_jump_threshold`` (the last
  one) is an Euler step;
- the jump to x0 at ``t >= t_jump_threshold`` as a scalar step-size select
  (``dt_eff``), never a tensor select;
- CFG ``doubled`` (one forward on 2B, conditional half first, zero null
  condition) or ``split`` (two forwards on B), and ``cfg_interval``;
- hoisted AdaLN tables for every schedule point;
- a caller-supplied initial noise ``z0``;
- ``renoise_sample``, the stochastic re-noising sampler (no CFG, no
  tables).

The schedule's scalars (``t``, ``dt``, ``dt_eff``, the guards) are computed
on the host in fp32, the dtype the JAX sampler computes them in, so the
loop never waits on the device.

Forwards a call makes, n steps: Euler n; Heun ``2n - k``, k the intervals
with ``t_next >= t_jump_threshold`` (1 for n < 1000), whose second forward
the JAX sampler computes and discards (``jnp.where``) and this one skips.
Each forward is one model call on 2B rows under ``doubled`` CFG and two on
B under ``split``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..configs import SamplerConfig
from ..utils.device import resolve_device


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num, float32)`` as XLA computes it under
    ``jit``: ``start * (1 - s) + i * f32(stop * r)`` with ``r = f32(1 /
    (num - 1))`` and ``s = i * r`` (the constant divide becomes a reciprocal
    multiply, and ``stop * (i * r)`` is reassociated), end point exact."""
    if num == 1:
        return np.array([start], np.float32)
    f32 = np.float32
    i = np.arange(num - 1, dtype=f32)
    r = f32(1.0 / (num - 1))
    out = f32(start) * (f32(1.0) - i * r) + i * (f32(stop) * r)
    return np.append(out, f32(stop)).astype(f32)


def flow_interpolate(x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """``z_t = t*x0 + (1-t)*noise`` with t ``[B]`` broadcast over x0."""
    t = t.reshape((-1,) + (1,) * (x0.ndim - 1)).to(x0.dtype)
    return t * x0 + (1.0 - t) * noise


def u_shaped(u: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """U-shaped t from uniforms ``u``: denser near 0 and 1."""
    lo = 0.5 * (2.0 * u) ** alpha
    hi = 1.0 - 0.5 * (2.0 * (1.0 - u)) ** alpha
    return torch.where(u < 0.5, lo, hi)


def u_shaped_timesteps(batch: int, alpha: float = 0.5,
                       generator: Optional[torch.Generator] = None,
                       device="cuda") -> torch.Tensor:
    """``[batch]`` fp32 U-shaped flow times drawn from ``generator``, on the
    card unless the caller asks for ``device="cpu"``."""
    u = torch.rand((batch,), generator=generator,
                   device=resolve_device(device))
    return u_shaped(u, alpha)


def timesteps(num_steps: int) -> np.ndarray:
    """The sampler's fp32 schedule ``linspace(0, 1, num_steps + 1)``."""
    return linspace_f32(0.0, 1.0, num_steps + 1)


def renoise_draw(generator: torch.Generator, shape, i: int,
                 device) -> torch.Tensor:
    """The i-th standard normal draw of :meth:`FlowSampler.renoise_sample`
    (i = n + 1 is the initial noise), fp32, from ``generator``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


class FlowSampler:
    """Euler or Heun ODE sampler for an x0-prediction model.

    Args:
        model_fn: ``f(z [B,T,C], t [B], cond [B,T,C], mod) -> x0 [B,T,C]``;
            ``mod`` is the step's AdaLN table (None without ``adaln_fn``).
        cfg: sampler hyperparameters.
        adaln_fn: ``f(t [n]) -> [depth, n, 6H]``; enables the hoisted path,
            where every schedule point's tables are computed once per call.
        device: where the initial noise is drawn; ``"cuda"`` by default.
    """

    def __init__(self, model_fn: Callable, cfg: Optional[SamplerConfig] = None,
                 adaln_fn: Optional[Callable] = None, device="cuda"):
        self.model_fn = model_fn
        self.cfg = cfg or SamplerConfig()
        self.adaln_fn = adaln_fn
        self.device = resolve_device(device)
        if self.cfg.solver not in ("euler", "heun"):
            raise ValueError(f"unknown solver {self.cfg.solver!r}")
        if self.cfg.cfg_batching not in ("doubled", "split"):
            raise ValueError(f"unknown cfg_batching {self.cfg.cfg_batching!r}")

    def _tables(self, ts: np.ndarray):
        if self.adaln_fn is None:
            return None
        return self.adaln_fn(torch.from_numpy(ts).to(self.device))

    @torch.no_grad()
    def __call__(self, cond: torch.Tensor, num_steps: Optional[int] = None,
                 cfg_scale: Optional[float] = None,
                 z0: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample HR latents from normalized LR-condition latents.

        Args:
            cond: [B, T, C] normalized LR latents.
            num_steps / cfg_scale: optional overrides of the config.
            z0: optional initial noise [B, T, C] fp32; else drawn from
                ``generator`` on the sampler's device.
        Returns:
            [B, T, C] fp32 generated normalized HR latents.
        """
        c = self.cfg
        n = num_steps or c.num_steps
        scale = c.cfg_scale if cfg_scale is None else cfg_scale
        if z0 is None:
            z0 = torch.randn(cond.shape, dtype=torch.float32,
                             device=self.device, generator=generator)
        ts = timesteps(n)
        mods = self._tables(ts)
        i_lo, i_hi = 0, 0
        if scale != 1.0:
            lo, hi = c.cfg_interval
            i_lo = max(0, min(n, round(lo * n)))
            i_hi = max(i_lo, min(n, round(hi * n)))
        B = cond.shape[0]
        null = torch.zeros_like(cond)
        cond2 = torch.cat([cond, null]) if c.cfg_batching == "doubled" else None
        eps = np.float32(c.velocity_eps)
        jump = np.float32(c.t_jump_threshold)
        s32 = float(np.float32(scale))
        heun = c.solver == "heun"
        guards = (np.float32(1.0) - ts) + eps  # at every schedule point
        # A divide by a host scalar becomes a reciprocal multiply on the
        # card; a 0-dim device tensor keeps it a true fp32 divide, as JAX's.
        guards_dev = torch.from_numpy(guards).to(cond.device)

        def model(z, t, cnd, i):
            t_b = torch.full((z.shape[0],), float(t), dtype=torch.float32,
                             device=z.device)
            mod = None if mods is None else mods[:, i:i + 1]
            return self.model_fn(z, t_b, cnd, mod).to(z.dtype)

        def velocity(z, i, guided):
            """The velocity at schedule point i."""
            t = ts[i]
            if guided:
                if cond2 is not None:
                    pred = model(torch.cat([z, z]), t, cond2, i)
                    x_c, x_u = pred[:B], pred[B:]
                else:
                    x_c = model(z, t, cond, i)
                    x_u = model(z, t, null, i)
                x_pred = x_u + s32 * (x_c - x_u)
            else:
                x_pred = model(z, t, cond, i)
            return (x_pred - z) / guards_dev[i]

        z = z0
        for i in range(n):
            t, t_next = ts[i], ts[i + 1]
            guided = i_lo <= i < i_hi
            dt = np.float32(t_next - t)
            v = velocity(z, i, guided)
            if heun and t_next < jump:
                v2 = velocity(z + v * float(dt), i + 1, guided)
                v = 0.5 * (v + v2)
            # t >= jump steps straight to x_pred = z + v * (1 - t + eps).
            dt_eff = dt if t < jump else guards[i]
            z = z + v * float(dt_eff)
        return z

    @torch.no_grad()
    def renoise_sample(self, generator: torch.Generator, cond: torch.Tensor,
                       num_steps: Optional[int] = None) -> torch.Tensor:
        """Re-noising sampler: predict x0, then re-interpolate it with
        fresh noise at the next t (``t_next * x0 + (1 - t_next) * noise``),
        the prediction itself at t = 1.  No CFG and no AdaLN tables.  The
        draws come from ``generator`` through :func:`renoise_draw`: the
        initial noise (i = n + 1), then one per step (i)."""
        n = num_steps or self.cfg.num_steps
        ts = timesteps(n)
        z = renoise_draw(generator, cond.shape, n + 1, self.device)
        for i in range(n):
            t_b = torch.full((z.shape[0],), float(ts[i]),
                             dtype=torch.float32, device=z.device)
            x_pred = self.model_fn(z, t_b, cond, None).to(z.dtype)
            noise = renoise_draw(generator, z.shape, i, self.device)
            t_next = ts[i + 1]
            z = (float(t_next) * x_pred
                 + float(np.float32(1.0) - t_next) * noise
                 if t_next < 1.0 else x_pred)
        return z
