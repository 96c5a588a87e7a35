"""Run directories, checkpoints and resume.

The port of the JAX package's ``train/checkpoint.py``, with its layout:

    <save_dir_base>/<preset>/<MMDDHHMM>/
        preset.json
        last/            best/            interval_<step>/
        last.meta.json   best.meta.json   interval_<step>.meta.json

A checkpoint directory holds ``state.pt``: the train state's
:meth:`~jatsr_torch.train.state.TrainState.state_dict` (step, seed,
parameters by module name, AdamW's count and moments by parameter name)
and the meta (epoch, global step, best validation loss, extras).  It is
written with ``torch.save`` into a temporary directory that is renamed
into place, so an interrupted write never stands as a checkpoint; the
``.meta.json`` beside it is a readable copy of the meta.  It is read with
``torch.load(weights_only=True)`` straight onto the state's device.

Resume is exact: the step's draws are a pure function of ``(seed, step)``
(``train/step.py``) and the crops of ``(seed, epoch, index)``, so the
state in the file is all the randomness there is.

Several processes (a mesh): every rank calls :meth:`CheckpointManager.save`
(the state dict gathers ZeRO-1's moments and the leaves a model group
splits: a file holds whole leaves, so it resumes on any mesh or on one
card), only the primary writes the files, the meta and the prunes, and every rank waits at a barrier before
:meth:`~CheckpointManager.save` returns and before a restore reads.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel.distributed import barrier
from .state import TrainState

STATE_FILE = "state.pt"


def timestamp_run_name() -> str:
    return datetime.now().strftime("%m%d%H%M")


def find_latest_run(base_dir: str) -> Optional[Path]:
    """The latest ``MMDDHHMM`` run directory under ``base_dir`` that holds a
    ``last`` checkpoint; None if there is none."""
    base = Path(base_dir)
    if not base.exists():
        return None
    runs = sorted((d for d in base.iterdir()
                   if d.is_dir() and d.name.isdigit() and len(d.name) == 8),
                  reverse=True)
    for run in runs:
        if (run / "last").exists():
            return run
    return None


class CheckpointManager:
    """Saves and restores the checkpoints of one run directory.

    ``primary``: this process writes (rank 0 of a mesh; every other rank
    passes False and only joins the collectives and barriers).  ``io``
    lists ``(op, name, bytes, seconds)`` for each :meth:`save` and
    :meth:`restore` (op "save" or "restore"), the file's size and the wall
    time of the whole call.
    """

    def __init__(self, run_dir, primary: bool = True):
        self.run_dir = Path(run_dir)
        self.primary = primary
        if primary:
            self.run_dir.mkdir(parents=True, exist_ok=True)
        self.io: List[Tuple[str, str, int, float]] = []

    def save(self, name: str, state: TrainState, epoch: int,
             best_val_loss: float, extra: Optional[Dict] = None):
        sd = state.state_dict()  # on every rank: ZeRO-1 gathers here
        if self.primary:
            self._write(name, sd, state, epoch, best_val_loss, extra)
        barrier()

    def _write(self, name, sd, state, epoch, best_val_loss, extra):
        t0 = time.perf_counter()
        meta = {"epoch": int(epoch), "global_step": int(state.step),
                "best_val_loss": float(best_val_loss), **(extra or {})}
        final = self.run_dir / name
        tmp = self.run_dir / f".{name}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"state": sd, "meta": meta}, tmp / STATE_FILE)
        nbytes = (tmp / STATE_FILE).stat().st_size
        old = None
        if final.exists():
            old = self.run_dir / f".{name}.old-{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            final.rename(old)
        tmp.rename(final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        side = self.run_dir / f".{name}.meta.json.tmp"
        side.write_text(json.dumps(meta))
        side.replace(self.run_dir / f"{name}.meta.json")
        self.io.append(("save", name, nbytes, time.perf_counter() - t0))

    def load(self, name: str, device="cpu") -> Dict:
        """The checkpoint's ``{"state": state_dict, "meta": meta}``, its
        tensors on ``device``."""
        path = self.run_dir / name / STATE_FILE
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint {name!r} in "
                                    f"{self.run_dir}")
        return torch.load(path, weights_only=True, map_location=device)

    def restore(self, name: str, state: TrainState
                ) -> Tuple[TrainState, Dict]:
        """Load checkpoint ``name`` into ``state`` (in place) and return it
        with the checkpoint's meta (every rank of a mesh reads it, after a
        barrier)."""
        barrier()
        t0 = time.perf_counter()
        blob = self.load(name, state.model.device)
        state.load_state_dict(blob["state"])
        del blob["state"]
        if state.model.device.type == "cuda":
            torch.cuda.synchronize(state.model.device)
        self.io.append(("restore", name,
                        (self.run_dir / name / STATE_FILE).stat().st_size,
                        time.perf_counter() - t0))
        return state, blob["meta"]

    def has(self, name: str) -> bool:
        return (self.run_dir / name).exists()

    def prune_intervals(self, keep: int):
        """Remove all but the newest ``keep`` interval checkpoints."""
        if keep <= 0 or not self.primary:
            return
        intervals = []
        for d in self.run_dir.iterdir():
            m = re.fullmatch(r"interval_(\d+)", d.name)
            if m and d.is_dir():
                intervals.append((int(m.group(1)), d))
        for _, d in sorted(intervals)[:-keep]:
            shutil.rmtree(d, ignore_errors=True)
            meta = Path(str(d) + ".meta.json")
            if meta.exists():
                meta.unlink()
