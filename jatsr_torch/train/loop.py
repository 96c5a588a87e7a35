"""Training loop: epochs, validation, TensorBoard scalars, checkpoints,
resume.

The port of the JAX package's ``train/loop.py``, on one card (or the CPU
when asked), or over the processes of a ``(D, M)`` mesh (``mesh=``; one
process a card under ``torchrun``): data-parallel over D, tensor-parallel
over M:

- the epoch loop, the training loader reshuffled per epoch
  (``set_epoch``);
- TB scalars every ``log_interval_steps`` (``Train/<metric>``, with
  ``steps_per_sec`` and ``MFU``), ``Train/EpochLoss`` and ``Val/<metric>``
  per epoch, under the JAX trainer's tags;
- ``interval_<step>`` checkpoints every ``save_interval_steps`` (the newest
  ``keep_interval_checkpoints`` kept), ``last`` every
  ``save_last_every_epochs``, ``best`` on a validation improvement at most
  every ``save_best_every_epochs``, and ``last`` on ``KeyboardInterrupt``;
- validation per epoch: the mean of each metric and ``loss_std``, each
  batch's draws fixed by its index.

Batches move to the card on the loader's prefetch thread
(:func:`put_batch`): a pinned copy of each array goes to the
card on a side stream, and the thread waits for that copy to finish before
it hands the batch over.  So a pinned buffer is never freed while its copy
runs, the step's stream never waits on a copy, and the main thread only
records its stream on the batch (``record_stream``) so that the caching
allocator does not reuse the batch's memory for the side stream while the
step still reads it.  The loaders' transform holds the device and the
stream, not the trainer, so a trainer that is dropped frees its state at
once (no reference cycle waits for the collector).

Under a mesh each rank loads its span of every global batch
(``BatchLoader(shard=(data rank, D))``: the model ranks of a data rank load
the same rows; ``batch_size`` is the global batch and must divide by D),
the model is drawn from the seed, broadcast from rank 0 over the whole
world as whole leaves and cut by each rank (``DenseDiT(mesh=)``), the step
and the validation reduce over ``"data"`` (so ``best`` is chosen alike
everywhere), and rank 0 alone names the run (``shared_run_name``), writes
the checkpoints (whole leaves: every rank joins the gathers),
``preset.json`` and the TensorBoard scalars.  ``train.shard_opt_state``
splits the moments (ZeRO-1).

MFU is against the H100's dense bf16 peak (``utils/flops.py``), a card's
share: the step's FLOPs over the world size.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import Preset
from ..data import BatchLoader, LatentDataset, ValidationDataset, load_stats
from ..models.dit import DenseDiT
from ..models.from_jax import init_dense_params
from ..parallel.distributed import (broadcast_tree, is_primary,
                                    shared_run_name, world)
from ..parallel.mesh import data_rank, data_size
from ..utils.device import resolve_device
from ..utils.flops import H100_BF16_PEAK_FLOPS, train_step_flops
from ..utils.profiling import StepTimer
from .checkpoint import CheckpointManager, find_latest_run, timestamp_run_name
from .state import create_train_state, make_optimizer
from .step import Normalizer, make_eval_step, make_train_step

# Validation batch i draws its t and noise from seed (_VAL_SEED << 32) + i.
_VAL_SEED = 1234


def _default_writer(log_dir: Path):
    """tensorboardX's writer, else torch's, else None."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir=str(log_dir))
    except Exception:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=str(log_dir))
    except Exception:
        return None


def put_batch(hr, lr, device, stream=None):
    """numpy ``(hr, lr)`` -> tensors on ``device`` (tensors pass as they
    are).  With a side ``stream``: pinned copies sent on it and waited for
    on this thread, so the pinned buffers outlive their copies."""
    if isinstance(hr, torch.Tensor):
        return hr, lr
    hr, lr = torch.from_numpy(hr), torch.from_numpy(lr)
    if stream is None:
        return hr.to(device), lr.to(device)
    with torch.cuda.stream(stream):
        out = tuple(x.pin_memory().to(device, non_blocking=True)
                    for x in (hr, lr))
    stream.synchronize()
    return out


class Trainer:
    """Args:
        preset: model, loss, train and data configs.
        data_dir: holds ``train/``, ``val/`` and the stats file
            (``preset.data.data_dir`` by default).
        resume: None (a new run), ``"auto"`` (the latest run under
            ``<save_dir_base>/<preset>`` with a ``last``, else a new one)
            or a run directory.
        mesh: None (one process), or a ``(D, M)`` mesh
            (``parallel.make_mesh``) over the process group: data-parallel
            over D ranks, tensor-parallel over M.
        run_name: the new run's directory name (a ``MMDDHHMM`` stamp by
            default).
        writer: an object with ``add_scalar(tag, value, step)`` and
            ``flush()``; None picks TensorBoard's where importable; False
            logs nothing.
        native_loader: assemble batches in ``native/`` (raises where the
            library cannot be built).
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.

    ``loader_wait_s`` and ``steps_done`` add up, over :meth:`fit` calls, the
    seconds the loop waited for the training loader and the steps it took.
    """

    def __init__(self, preset: Preset, data_dir: Optional[str] = None,
                 resume: Optional[str] = None, mesh=None,
                 run_name: Optional[str] = None, writer=None,
                 native_loader: bool = False, device="cuda"):
        self.preset = preset
        mcfg, tcfg, dcfg = preset.model, preset.train, preset.data
        data_dir = data_dir or dcfg.data_dir
        D = data_size(mesh)
        self.n_procs = world()[1]
        self.primary = is_primary()
        if self.n_procs > 1 and mesh is None:
            raise ValueError("multi-process training requires a device mesh")
        if tcfg.batch_size % D:
            raise ValueError(f"batch_size {tcfg.batch_size} must be divisible "
                             f"by the data-parallel axis ({D}): pass "
                             f"--batch-size accordingly")
        shard = (data_rank(mesh), D) if D > 1 else None
        self.device = resolve_device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

        # Data.
        target = dcfg.target_frames
        self.train_loader = BatchLoader(
            LatentDataset(data_dir, "train", target,
                          dcfg.samples_per_epoch_multiplier, seed=tcfg.seed),
            tcfg.batch_size, shuffle=True, seed=tcfg.seed,
            native=native_loader, shard=shard)
        self.val_loader = BatchLoader(
            ValidationDataset(data_dir, "val", target,
                              dcfg.samples_per_epoch_multiplier),
            tcfg.batch_size, shuffle=False, shard=shard)
        if len(self.val_loader) == 0:
            raise ValueError(f"the validation split of {data_dir} gives no "
                             f"batch of {tcfg.batch_size}")
        self.normalizer = Normalizer(
            *load_stats(str(Path(data_dir) / dcfg.stats_file)),
            device=self.device)

        # Model and state, drawn from the seed as flax initialises them
        # (under a mesh, rank 0's whole leaves broadcast, then each rank's
        # cut: one start everywhere).
        tree = broadcast_tree(init_dense_params(
            mcfg, torch.Generator().manual_seed(tcfg.seed)))
        self.model = DenseDiT(mcfg, tree, device=self.device, mesh=mesh)
        del tree
        sample = next(iter(BatchLoader(self.train_loader.ds, tcfg.batch_size,
                                       shuffle=False, prefetch=0)))
        self.total_steps = len(self.train_loader) * tcfg.num_epochs
        self.state = create_train_state(self.model, tcfg, self.total_steps,
                                        sample, device=self.device, mesh=mesh)
        tp = self.model.tp
        self.n_params = sum(p.numel() * (1 if k not in self.model.split_dims
                                         else tp.size)
                            for k, p in self.model.named_parameters())
        self._flops_per_step = train_step_flops(
            mcfg, tcfg.batch_size, target,
            tcfg.grad_accum_steps) / self.n_procs
        self._peak_flops = H100_BF16_PEAK_FLOPS
        self.train_step = make_train_step(preset.loss, tcfg, self.normalizer,
                                          mesh=mesh)
        self.eval_step = make_eval_step(preset.loss, self.normalizer,
                                        mesh=mesh)
        self._put = functools.partial(put_batch, device=self.device,
                                      stream=self._copy_stream)
        self.train_loader.transform = self.val_loader.transform = self._put
        self.loader_wait_s, self.steps_done = 0.0, 0

        # Run directory and resume.
        base = Path(tcfg.save_dir_base) / preset.name
        self.start_epoch = 0
        self.best_val_loss = float("inf")
        # -1: the first best-save may land at epoch >= cadence - 1.
        self._last_best_save_epoch = -1
        if resume == "auto":
            latest = find_latest_run(str(base))
            run_dir = latest if latest else base / (
                run_name or timestamp_run_name())
        elif resume:
            run_dir = Path(resume)
        else:
            run_dir = base / (run_name or timestamp_run_name())
        if self.n_procs > 1:
            run_dir = Path(run_dir).parent / shared_run_name(
                Path(run_dir).name)
        self.ckpt = CheckpointManager(run_dir, primary=self.primary)
        if resume and self.ckpt.has("last"):
            self.state, meta = self.ckpt.restore("last", self.state)
            self.start_epoch = meta["epoch"] + 1
            self.best_val_loss = meta["best_val_loss"]
            if self.primary:
                print(f"[trainer] resumed from {run_dir} at epoch "
                      f"{self.start_epoch}, step {self.state.step}")

        self.writer = writer if self.primary else False
        if self.writer is None:
            self.writer = _default_writer(Path(tcfg.log_dir_base)
                                          / preset.name / run_dir.name)
        if self.primary:
            (self.ckpt.run_dir / "preset.json").write_text(preset.to_json())

    # ------------------------------------------------------------------

    def _ready(self, hr, lr):
        """A batch from a loader, usable on this thread's stream."""
        hr, lr = self._put(hr, lr)
        if self._copy_stream is not None:
            stream = torch.cuda.current_stream(self.device)
            hr.record_stream(stream)
            lr.record_stream(stream)
        return hr, lr

    def _log(self, tag_values: Dict[str, float], step: int, prefix: str):
        if not self.writer:
            return
        for k, v in tag_values.items():
            self.writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def validate(self) -> Dict[str, float]:
        """Mean of each eval metric over the validation batches, and
        ``loss_std`` over the batch losses; one host read at the end.  Under
        a mesh each batch's metrics are the global batch's (the eval step
        reduces them), so every rank gets the same numbers."""
        device_metrics = []
        for i, (hr, lr) in enumerate(self.val_loader):
            hr, lr = self._ready(hr, lr)
            device_metrics.append(self.eval_step(
                self.state, hr, lr, seed=(_VAL_SEED << 32) + i))
        keys = list(device_metrics[0])
        table = torch.stack([torch.stack([m[k].float() for k in keys])
                             for m in device_metrics]).cpu().numpy()
        out = {k: float(v) for k, v in zip(keys, table.sum(0) / len(table))}
        losses = table[:, keys.index("loss")]
        out["loss_std"] = float(np.std(losses)) if len(losses) > 1 else 0.0
        return out

    def fit(self, num_epochs: Optional[int] = None, max_steps: int = 0,
            verbose: bool = True):
        """Train from ``start_epoch`` to ``num_epochs`` (the preset's by
        default), or until the state's step reaches ``max_steps``; returns
        the best validation loss.  A ``num_epochs`` other than the preset's
        sets the schedule's horizon to it and keeps the moments."""
        tcfg = self.preset.train
        num_epochs = num_epochs or tcfg.num_epochs
        extra = {"preset": self.preset.name}
        effective_total = len(self.train_loader) * num_epochs
        if effective_total != self.total_steps:
            self.total_steps = effective_total
            self.state.tx = make_optimizer(tcfg, effective_total)

        timer = StepTimer()
        self._last_completed_epoch = self.start_epoch - 1
        try:
            self._fit_epochs(num_epochs, max_steps, verbose, timer, tcfg,
                             extra)
        except KeyboardInterrupt:
            # Leave a resumable `last`: the last completed epoch, so that a
            # resume replays the interrupted one.
            print("[trainer] interrupted: saving last checkpoint")
            self.ckpt.save("last", self.state, self._last_completed_epoch,
                           self.best_val_loss, extra)
            raise
        if self.writer:
            self.writer.flush()
        return self.best_val_loss

    def _fit_epochs(self, num_epochs, max_steps, verbose, timer, tcfg, extra):
        step_count = self.state.step
        for epoch in range(self.start_epoch, num_epochs):
            self.train_loader.set_epoch(epoch)
            t0 = time.time()
            epoch_loss, epoch_batches = 0.0, 0
            batches = iter(self.train_loader)
            while True:
                w0 = time.perf_counter()
                batch = next(batches, None)
                self.loader_wait_s += time.perf_counter() - w0
                if batch is None:
                    break
                hr, lr = self._ready(*batch)
                self.state, metrics = self.train_step(self.state, hr, lr)
                step_count += 1
                epoch_batches += 1
                self.steps_done += 1
                # A device sum: no host read until the epoch's end.
                epoch_loss = epoch_loss + metrics["loss"]
                if step_count % tcfg.log_interval_steps == 0:
                    vals = {k: float(v) for k, v in metrics.items()}
                    timer.tick()
                    vals["steps_per_sec"] = timer.steps_per_sec() \
                        * tcfg.log_interval_steps
                    if vals["steps_per_sec"] > 0:
                        vals["MFU"] = self._flops_per_step \
                            * vals["steps_per_sec"] / self._peak_flops
                    self._log(vals, step_count, "Train")
                if (tcfg.save_interval_steps
                        and step_count % tcfg.save_interval_steps == 0):
                    self.ckpt.save(f"interval_{step_count}", self.state,
                                   epoch, self.best_val_loss, extra)
                    self.ckpt.prune_intervals(tcfg.keep_interval_checkpoints)
                if max_steps and step_count >= max_steps:
                    break
            batches.close()  # ends the prefetch thread after a break

            self._last_completed_epoch = epoch
            every = max(1, tcfg.save_last_every_epochs)
            if (epoch + 1) % every == 0 or epoch == num_epochs - 1:
                self.ckpt.save("last", self.state, epoch, self.best_val_loss,
                               extra)
            mean_train_loss = float(epoch_loss) / max(epoch_batches, 1)
            self._log({"EpochLoss": mean_train_loss}, epoch, "Train")
            val = self.validate()
            self._log(val, epoch, "Val")
            if val["loss"] < self.best_val_loss:
                # best_val_loss moves only when a `best` is written, so the
                # threshold in `last`'s meta always matches `best` on disk.
                best_every = max(1, tcfg.save_best_every_epochs)
                if (epoch - self._last_best_save_epoch >= best_every
                        or epoch == num_epochs - 1):
                    self.best_val_loss = val["loss"]
                    self.ckpt.save("best", self.state, epoch,
                                   self.best_val_loss, extra)
                    self._last_best_save_epoch = epoch
            if verbose and self.primary:
                print(f"[epoch {epoch}] {epoch_batches} steps in "
                      f"{time.time() - t0:.1f}s | train loss "
                      f"{mean_train_loss:.5f} | val loss {val['loss']:.5f} "
                      f"± {val['loss_std']:.5f} (best "
                      f"{self.best_val_loss:.5f})")
            if max_steps and step_count >= max_steps:
                break
