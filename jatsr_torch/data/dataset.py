"""Latent datasets and the batch loader.

The port's copy of the JAX package's ``data/dataset.py``, pure numpy: fp16
latents memory-mapped per song, an epoch multiplier, loop-padding for short
songs, random crops for training and deterministic spread crops for
validation, fp16 -> fp32 only after cropping.  The batches are those of the
JAX loader bit for bit: the shuffle is a function of ``seed + epoch``, each
crop of ``(seed, epoch, idx)``, so a run resumed at an epoch boundary reads
the same crops.

``BatchLoader(native=True)`` assembles batches in the C++ engine of
``native/`` (``data/native_loader.py``) instead of numpy; its
``transform`` runs on the prefetch thread (the trainer moves batches to
the card there).
"""

from __future__ import annotations

import json
import math
import queue as queue_mod
import threading
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


def load_stats(path: str):
    """Normalization stats JSON -> ``(hr_mean, hr_std, lr_mean, lr_std)``,
    each float32 ``[C]``."""
    with open(path) as f:
        d = json.load(f)
    return tuple(np.asarray(d[k], np.float32)
                 for k in ("hr_mean", "hr_std", "lr_mean", "lr_std"))


class _LatentFiles:
    """The ``*.hr.npy`` / ``*.lr.npy`` pairs of one split, sorted by name."""

    def __init__(self, data_dir: str, split: str):
        self.files = sorted(Path(data_dir, split).glob("*.hr.npy"))
        if not self.files:
            raise ValueError(f"no *.hr.npy under {data_dir}/{split}")
        self._cache = {}

    def __len__(self):
        return len(self.files)

    def get(self, idx: int):
        """mmap views ``(hr, lr)`` ``[T, C]`` fp16, cached."""
        if idx not in self._cache:
            hr_path = self.files[idx]
            hr = np.load(hr_path, mmap_mode="r")
            lr = np.load(str(hr_path).replace(".hr.npy", ".lr.npy"),
                         mmap_mode="r")
            self._cache[idx] = (hr, lr)
        return self._cache[idx]


def _crop_or_loop(hr, lr, start: int, target: int):
    """``target`` frames from ``start``; a song shorter than ``target`` is
    tiled from its start.  fp32 out."""
    length = hr.shape[0]
    if length < target:
        reps = math.ceil(target / length)
        hr = np.tile(np.asarray(hr), (reps, 1))[:target]
        lr = np.tile(np.asarray(lr), (reps, 1))[:target]
    else:
        hr = np.asarray(hr[start:start + target])
        lr = np.asarray(lr[start:start + target])
    return hr.astype(np.float32), lr.astype(np.float32)


class LatentDataset:
    """Training crops: ``multiplier`` random crops per song and epoch."""

    def __init__(self, data_dir: str, split: str = "train",
                 target_frames: int = 1378, multiplier: int = 6,
                 seed: int = 0):
        self.store = _LatentFiles(data_dir, split)
        self.target = target_frames
        self.multiplier = multiplier
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.store) * self.multiplier

    def sample_plan(self, idx: int) -> Tuple[int, int]:
        """``(file_idx, crop_start)`` of sample ``idx``, a pure function of
        ``(seed, epoch, idx)``; shared by the numpy and native paths."""
        file_idx = idx % len(self.store)
        hr, _ = self.store.get(file_idx)
        length = hr.shape[0]
        if length <= self.target:
            return file_idx, 0
        mix = (self.seed * 1_000_003 + self.epoch * 9_176 + idx) % (2**31 - 1)
        start = np.random.RandomState(mix).randint(0, length - self.target + 1)
        return file_idx, int(start)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        file_idx, start = self.sample_plan(idx)
        hr, lr = self.store.get(file_idx)
        return _crop_or_loop(hr, lr, start, self.target)


class ValidationDataset:
    """Deterministic crops, ``multiplier`` per song spread evenly over it."""

    def __init__(self, data_dir: str, split: str = "val",
                 target_frames: int = 1378, multiplier: int = 6):
        self.store = _LatentFiles(data_dir, split)
        self.target = target_frames
        self.multiplier = multiplier

    def __len__(self):
        return len(self.store) * self.multiplier

    def sample_plan(self, idx: int) -> Tuple[int, int]:
        file_idx = idx % len(self.store)
        sample_idx = idx // len(self.store)
        hr, _ = self.store.get(file_idx)
        length = hr.shape[0]
        if length <= self.target:
            start = 0
        elif self.multiplier == 1:
            start = (length - self.target) // 2
        else:
            seg = max(length - self.target, 1)
            start = min(int(seg * sample_idx / (self.multiplier - 1)),
                        length - self.target)
        return file_idx, start

    def __getitem__(self, idx: int):
        file_idx, start = self.sample_plan(idx)
        hr, lr = self.store.get(file_idx)
        return _crop_or_loop(hr, lr, start, self.target)


class BatchLoader:
    """Batches ``(hr, lr)`` float32 ``[B, T, C]``, with background prefetch.

    ``shuffle`` permutes the sample indices per epoch by ``seed + epoch``
    (``set_epoch``).  ``transform(hr, lr) -> (hr, lr)`` runs on the
    prefetch thread.  ``shard=(process_index, process_count)`` gives each
    process its contiguous span of every global batch (``batch_size`` stays
    the global batch; ``drop_last`` is required).  ``native=True`` fills
    batches through the C++ engine and raises ``RuntimeError`` where the
    library cannot be built.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 native: bool = False, native_threads: int = 4,
                 transform=None, shard=None):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.prefetch = prefetch
        self.transform = transform
        self.shard = shard
        if shard is not None:
            pid, n = shard
            if batch_size % n:
                raise ValueError(f"global batch {batch_size} must divide by "
                                 f"process count {n}")
            if not drop_last:
                raise ValueError("sharded loading requires drop_last")
            assert 0 <= pid < n, shard
        self._native_store = None
        if native:
            from .native_loader import (NativeLatentStore, build_error,
                                        is_available)

            if not is_available():
                raise RuntimeError(f"native loader requested but "
                                   f"unavailable: {build_error()}")
            self._native_store = NativeLatentStore(
                [str(p) for p in dataset.store.files],
                n_threads=native_threads)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else math.ceil(n / self.bs)

    def _indices(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _assemble(self, batch_idx) -> Tuple[np.ndarray, np.ndarray]:
        if self._native_store is not None:
            plans = [self.ds.sample_plan(int(i)) for i in batch_idx]
            hr, lr = self._native_store.fill_batch(
                np.asarray([p[0] for p in plans], np.int64),
                np.asarray([p[1] for p in plans], np.int64), self.ds.target)
        else:
            samples = [self.ds[int(i)] for i in batch_idx]
            hr = np.stack([s[0] for s in samples])
            lr = np.stack([s[1] for s in samples])
        if self.transform is not None:
            hr, lr = self.transform(hr, lr)
        return hr, lr

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        batches = [idx[i:i + self.bs] for i in range(0, len(idx), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]
        if self.shard is not None:
            pid, n = self.shard
            per = self.bs // n
            batches = [b[pid * per:(pid + 1) * per] for b in batches]
        if self.prefetch <= 0:
            for b in batches:
                yield self._assemble(b)
            return

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = object()
        failed = []
        closed = threading.Event()

        def worker():
            try:
                for b in batches:
                    if closed.is_set():
                        break
                    q.put(self._assemble(b))
            except BaseException as e:  # re-raised on the consumer's side
                failed.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # A consumer that stops early (max_steps) lets the worker end:
            # it drops what it prefetched and finishes its current batch.
            closed.set()
            while t.is_alive() or not q.empty():
                try:
                    q.get(timeout=0.05)
                except queue_mod.Empty:
                    pass
        if failed:
            raise failed[0]
