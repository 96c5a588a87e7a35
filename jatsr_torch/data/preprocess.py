"""Offline preprocessing: audio -> per-song fp16 DAC latents + global stats.

The port's copy of the JAX package's ``data/preprocess.py`` (itself the
reference's prepare_dataset_v5.py, "V13 final"), on the card:

per song (prepare_dataset_v5.py:97-277):
  load WAV -> mono -> peak-normalise if peak > 1
  chunk into 7 s valid + 0.5 s context each side (8 s windows, edge-padded)
  resample to 48 kHz, simulate LR by 48k -> 16k -> 48k
  resample both to 44.1 kHz and DAC-encode (the song's windows batched)
  trim the context frames, concatenate, clamp to the expected frame count
  save fp16 per-song latents; accumulate float64 per-channel stats

The files are the JAX package's: ``<split>/<song>.hr.npy`` and ``.lr.npy``
(fp16, time-major ``[T, latent_dim]``) with ``<song>.meta.json``, the
append-only ``processed_files.jsonl`` (done, skipped, error, redone),
``running_stats.npz`` every ``stats_interval`` songs, and
``global_stats.json`` / ``global_stats_separated.json``.

Where the port differs from the JAX package, by design:
- The encode runs eagerly (the port has no ``jax.jit``): one call of
  :func:`encode_windows` a song, fp32 (TF32 off), on the codec's device.
- A song's windows are not padded to a power-of-two count: that bucket only
  bounded XLA's compiles, and the zero windows cost encode time here.  The
  power-of-two *sample* bucket of ``chunking="whole"`` stays: it sets which
  zeros the encoder sees at the song's end.
- A song's resample to 48 kHz and its windowing run on the encode's device,
  in front of the encode (the JAX package resamples on its default device
  too).  The prefetch thread decodes the next WAV with numpy only: torch
  ops on two threads at once contend for torch's CPU thread pool.
"""

from __future__ import annotations

import json
import math
import queue as queue_mod
import threading
import traceback
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import DataConfig
from ..models.dac import DAC
from ..models.dac.model import DACConfig, encoder_forward, quantize
from ..ops.resample import resample, simulate_lr
from ..utils.audio_io import SUPPORTED_EXTENSIONS, load_wav


def scan_and_split(source_dirs: Sequence[str], val_ratio: float,
                   seed: int) -> Tuple[List[str], List[str]]:
    """Recursive scan + seeded shuffle + train/val split
    (prepare_dataset_v5.py:293-307)."""
    files: List[str] = []
    for d in source_dirs:
        p = Path(d)
        if p.exists():
            files.extend(
                str(f) for f in sorted(p.rglob("*"))
                if f.suffix.lower() in SUPPORTED_EXTENSIONS
            )
    rng = np.random.RandomState(seed)
    rng.shuffle(files)
    split = int(len(files) * (1 - val_ratio))
    return files[:split], files[split:]


class StatsAccumulator:
    """Per-channel float64 running stats, combined and separated HR/LR."""

    def __init__(self, channels: int = 1024):
        self.c = channels
        self.hr_sum = np.zeros(channels, np.float64)
        self.hr_sq = np.zeros(channels, np.float64)
        self.hr_n = 0
        self.lr_sum = np.zeros(channels, np.float64)
        self.lr_sq = np.zeros(channels, np.float64)
        self.lr_n = 0

    def update(self, hr: np.ndarray, lr: np.ndarray):
        """hr/lr: [T, C] latents of one song."""
        hr64, lr64 = hr.astype(np.float64), lr.astype(np.float64)
        self.hr_sum += hr64.sum(0)
        self.hr_sq += (hr64**2).sum(0)
        self.hr_n += hr.shape[0]
        self.lr_sum += lr64.sum(0)
        self.lr_sq += (lr64**2).sum(0)
        self.lr_n += lr.shape[0]

    def save(self, path: Path):
        np.savez(
            path,
            hr_sum=self.hr_sum, hr_sq=self.hr_sq, hr_n=self.hr_n,
            lr_sum=self.lr_sum, lr_sq=self.lr_sq, lr_n=self.lr_n,
        )

    @classmethod
    def load(cls, path: Path, channels: int = 1024) -> "StatsAccumulator":
        acc = cls(channels)
        z = np.load(path)
        acc.hr_sum, acc.hr_sq, acc.hr_n = z["hr_sum"], z["hr_sq"], int(z["hr_n"])
        acc.lr_sum, acc.lr_sq, acc.lr_n = z["lr_sum"], z["lr_sq"], int(z["lr_n"])
        return acc

    @staticmethod
    def _finalize(s, sq, n):
        mean = s / max(n, 1)
        var = sq / max(n, 1) - mean**2
        std = np.sqrt(np.clip(var, 1e-6, None))
        return mean, std

    def combined_stats(self) -> Dict:
        """Pooled HR+LR stats (prepare_dataset_v5.py:383-398 uses one pool
        for both)."""
        mean, std = self._finalize(
            self.hr_sum + self.lr_sum, self.hr_sq + self.lr_sq,
            self.hr_n + self.lr_n,
        )
        return {
            "hr_mean": mean.astype(np.float32).tolist(),
            "hr_std": std.astype(np.float32).tolist(),
            "lr_mean": mean.astype(np.float32).tolist(),
            "lr_std": std.astype(np.float32).tolist(),
            "total_frames": int(self.hr_n + self.lr_n),
        }

    def scalar_separated_stats(self) -> Dict:
        """SCALAR (not per-channel) HR/LR mean/std: the v2 generation's
        statistics (scripts/prepare_dataset_v2.py:490-504 computes one
        mean/std over all elements per domain)."""
        def fin(s, sq, n):
            n = max(n * self.c, 1)
            mean = s.sum() / n
            var = sq.sum() / n - mean**2
            return float(mean), float(np.sqrt(max(var, 1e-6)))

        hm, hs = fin(self.hr_sum, self.hr_sq, self.hr_n)
        lm, ls = fin(self.lr_sum, self.lr_sq, self.lr_n)
        return {"hr_mean": hm, "hr_std": hs, "lr_mean": lm, "lr_std": ls}

    def separated_stats(self) -> Dict:
        """Separated HR vs LR stats, what training reads
        (recalculate_stats.py, train_ddp_v3mod2.py:334)."""
        hm, hs = self._finalize(self.hr_sum, self.hr_sq, self.hr_n)
        lm, ls = self._finalize(self.lr_sum, self.lr_sq, self.lr_n)
        return {
            "hr_mean": hm.astype(np.float32).tolist(),
            "hr_std": hs.astype(np.float32).tolist(),
            "lr_mean": lm.astype(np.float32).tolist(),
            "lr_std": ls.astype(np.float32).tolist(),
            "total_frames": int(self.hr_n),
        }


def _pad_to_hop(x: torch.Tensor, hop: int) -> torch.Tensor:
    """``[N, T, 1]`` zero-padded at the end to a multiple of ``hop``."""
    return torch.nn.functional.pad(x, (0, 0, 0, (-x.shape[1]) % hop))


@torch.no_grad()
def encode_windows(encoder: Dict, quantizer: Dict, codec_cfg: DACConfig,
                   cfg: DataConfig, wins: torch.Tensor, low_sr=None):
    """48 kHz windows ``[N, W, 1]`` -> the quantised latents ``(z_hr, z_lr)``
    ``[N, F, latent_dim]``, on ``wins``' device: LR simulated at ``low_sr``
    (``cfg.low_sr`` by default), both resampled to the codec's rate, padded
    to its hop, encoded and quantised (the JAX package's jitted
    ``encode_windows``).  With ``low_sr`` given only ``z_lr`` is made (the
    LR-only refinement) and ``z_hr`` is None."""
    lr48 = simulate_lr(wins, cfg.high_sr, low_sr or cfg.low_sr)
    hop = codec_cfg.hop_length

    def encode(x):
        x = _pad_to_hop(resample(x, cfg.high_sr, cfg.dac_sample_rate), hop)
        return quantize(quantizer, encoder_forward(encoder, x, codec_cfg),
                        codec_cfg)[0]

    return (None if low_sr else encode(wins)), encode(lr48)


def _tree_to(tree, device):
    """A codec weight tree (nested dicts of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class PreprocessPipeline:
    """Batched, resumable audio -> latent preprocessing."""

    def __init__(self, codec: DAC, cfg: Optional[DataConfig] = None,
                 output_dir: str = "data_processed", devices=None):
        """``codec``: a whole codec (encoder and quantizer) on its device.
        ``devices``: an optional list of ``torch.device``s: song encodes go
        to them round-robin, each with its own copy of the codec's weights,
        and a song's fetch is deferred ``len(devices)`` songs, so that
        consecutive songs encode at once on different cards (the
        reference's one-worker-process-per-GPU pool,
        prepare_dataset_v5.py:326-381).  None: the codec's device."""
        codec._need_encoder()
        self.codec = codec
        self.cfg = cfg or DataConfig()
        self.devices = [torch.device(d) for d in devices] if devices else None
        self._weights_by_dev = {codec.device: (codec.encoder,
                                               codec.quantizer)}
        self._enc_rr = 0
        self.out = Path(output_dir)
        (self.out / "train").mkdir(parents=True, exist_ok=True)
        (self.out / "val").mkdir(parents=True, exist_ok=True)
        self.log_file = self.out / "processed_files.jsonl"
        self.stats_file = self.out / "running_stats.npz"
        self.acc = (
            StatsAccumulator.load(self.stats_file, codec.cfg.latent_dim)
            if self.stats_file.exists()
            else StatsAccumulator(codec.cfg.latent_dim)
        )
        c = self.cfg
        if c.chunking == "plain":
            # v3 scheme: fixed windows, no context frames
            # (scripts/prepare_dataset_v3.py:44,74-110).
            self._win_samples = int(c.chunk_duration * c.high_sr)
            self._valid_samples = self._win_samples
            self._overlap_samples = 0
        else:  # "overlap" (v4/v5) and "whole" (v2, windowed per song)
            self._win_samples = int(
                (c.chunk_duration + 2 * c.overlap_duration) * c.high_sr
            )
            self._valid_samples = int(c.chunk_duration * c.high_sr)
            self._overlap_samples = int(c.overlap_duration * c.high_sr)

    # -- resume log ---------------------------------------------------------

    def _log(self, entry: Dict):
        with open(self.log_file, "a") as f:
            f.write(json.dumps(entry, ensure_ascii=False) + "\n")

    def processed_set(self) -> set:
        done = set()
        if self.log_file.exists():
            for line in self.log_file.read_text().splitlines():
                try:
                    d = json.loads(line)
                    if d.get("status") == "done":
                        done.add(d["path"])
                except (json.JSONDecodeError, KeyError, AttributeError):
                    pass  # a line cut by a crash
        return done

    # -- per-song processing ------------------------------------------------

    def _window_song(self, audio48: torch.Tensor) -> torch.Tensor:
        """Slice one 48 kHz mono song ``[T]`` into overlapping 8 s windows
        ``[N, W, 1]`` (7 s valid + 0.5 s context each side), edge windows
        zero-padded (prepare_dataset_v5.py:142-169), on the song's device:
        window i holds samples ``[i * valid - overlap, + W)``."""
        total = audio48.shape[0]
        n_chunks = math.ceil(total / self._valid_samples)
        end = (n_chunks - 1) * self._valid_samples + self._win_samples
        x = F.pad(audio48, (self._overlap_samples,
                            max(0, end - self._overlap_samples - total)))
        return x.unfold(0, self._win_samples, self._valid_samples)[
            :n_chunks, :, None].contiguous()

    def _prepare_song(self, path: str):
        """HOST side of one song: decode, mono, peak-normalise, check the
        duration.  Returns ``(audio [T] fp32, duration s, sr)``.  Runs on
        the prefetch thread, so that the next song's IO and decode overlap
        the current song's encode (the reference overlapped through worker
        processes, prepare_dataset_v5.py:326-381); it runs no torch op, so
        that it never competes with the encode for torch's CPU threads."""
        audio, sr = load_wav(path, mono=True)
        peak = np.abs(audio).max() if audio.size else 0.0
        if peak > 1.0:
            audio = audio / peak
        duration = len(audio) / sr
        if duration < self.cfg.min_duration:
            raise ValueError("too_short")
        return np.ascontiguousarray(audio, np.float32), duration, sr

    def _at_high_sr(self, audio: np.ndarray, sr: int, dev) -> torch.Tensor:
        """The song on ``dev``, resampled to ``high_sr``."""
        x = torch.from_numpy(audio).to(dev)
        if sr != self.cfg.high_sr:
            x = resample(x[None], sr, self.cfg.high_sr)[0]
        return x

    def process_song(self, path: str) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Returns (hr [T,C] fp16, lr [T,C] fp16, metadata)."""
        prepared = self._prepare_song(path)
        return self._finalize_encode(path, prepared,
                                     self._dispatch_encode(prepared))

    def _dispatch_encode(self, prepared):
        """DEVICE side, on the next device of the round-robin: the song
        resampled to ``high_sr`` and windowed (``"whole"``: one window,
        zero-padded to the next power of two of samples, as the JAX package
        buckets it; its encoder sees those zeros), then the batched encode.
        Returns ``(z_hr, z_lr, window samples, song samples)``, the latents
        on the device: the card runs asynchronously, so encodes on distinct
        devices run at once; the fetch is :meth:`_finalize_encode`'s."""
        dev = (self.devices[self._enc_rr % len(self.devices)]
               if self.devices else self.codec.device)
        self._enc_rr += 1
        if dev not in self._weights_by_dev:
            self._weights_by_dev[dev] = (_tree_to(self.codec.encoder, dev),
                                         _tree_to(self.codec.quantizer, dev))
        enc, quant = self._weights_by_dev[dev]
        audio, _, sr = prepared
        x = self._at_high_sr(audio, sr, dev)
        if self.cfg.chunking == "whole":
            bucket_len = max(1024, 1 << (x.shape[0] - 1).bit_length())
            wins = F.pad(x, (0, bucket_len - x.shape[0]))[None, :, None]
        else:
            wins = self._window_song(x)
        z_hr, z_lr = encode_windows(enc, quant, self.codec.cfg, self.cfg,
                                    wins)
        return z_hr, z_lr, wins.shape[1], x.shape[0]

    def _trim(self, z: np.ndarray, win_len: int, n_samples: int
              ) -> np.ndarray:
        """``[N, F, C]`` window latents -> the song's ``[T, C]``: the
        context frames trimmed as the reference measures them (the hop
        inferred from the encode, prepare_dataset_v5.py:222-235), then
        clamped to the expected frame count."""
        hop48 = win_len / z.shape[1]
        if self.cfg.chunking == "whole":
            trim, valid = 0, z.shape[1]
        else:
            trim = int(self._overlap_samples / hop48)
            valid = int(self._valid_samples / hop48)
        full = z[:, trim : trim + valid, :].reshape(-1, z.shape[-1])
        return full[: int(n_samples / hop48)]

    def _finalize_encode(self, path: str, prepared, z
                         ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """HOST side: fetch the encode's results, trim, build metadata."""
        _, duration, sr = prepared
        z_hr, z_lr, win_len, n_samples = z
        full_hr = self._trim(z_hr.cpu().numpy(), win_len, n_samples)
        full_lr = self._trim(z_lr.cpu().numpy(), win_len, n_samples)
        meta = {
            "name": Path(path).stem,
            "path": path,
            "duration": duration,
            "sr": sr,
            "frames": int(full_hr.shape[0]),
        }
        return full_hr.astype(np.float16), full_lr.astype(np.float16), meta

    def _save_song(self, split: str, hr, lr, meta):
        base = self.out / split / meta["name"]
        np.save(str(base) + ".hr.npy", hr)
        np.save(str(base) + ".lr.npy", lr)
        (Path(str(base) + ".meta.json")).write_text(json.dumps(meta))

    # -- the run loop -------------------------------------------------------

    def _prepared(self, todo, prefetch: bool):
        """``(path, split, prepared or None, error or None)`` for each task,
        prepared one song ahead on a thread (``prefetch``) or in line."""
        def one(path, split):
            try:
                return path, split, self._prepare_song(path), None
            except Exception as e:  # noqa: BLE001 - attributed by run()
                return path, split, None, e

        if not prefetch:
            # The serial shape (host prepare, then the encode): the overlap
            # A/B measurement's other half.
            yield from (one(p, s) for p, s in todo)
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            for path, split in todo:
                if stop.is_set():
                    break
                q.put(one(path, split))
            q.put(None)

        worker = threading.Thread(target=producer, daemon=True,
                                  name="preprocess-prefetch")
        worker.start()
        try:
            yield from iter(q.get, None)
        finally:
            stop.set()
            while worker.is_alive():  # unblock a put on a full queue
                try:
                    q.get(timeout=0.1)
                except queue_mod.Empty:
                    pass
            worker.join()

    def run(self, source_dirs: Sequence[str], stats_interval: int = 50,
            verbose: bool = True, num_shards: int = 1,
            shard_index: int = 0, prefetch: bool = True) -> Dict:
        """``num_shards``/``shard_index`` partition the task list for
        multi-host preprocessing (the reference's one-worker-per-GPU pool,
        prepare_dataset_v5.py:326-341, scaled across machines; each host
        keeps its own jsonl log and running stats, merged by
        ``compute_separated_stats`` afterwards)."""
        c = self.cfg
        train_files, val_files = scan_and_split(
            source_dirs, c.val_ratio, c.split_seed
        )
        tasks = [(f, "train") for f in train_files] + [
            (f, "val") for f in val_files
        ]
        if num_shards > 1:
            tasks = tasks[shard_index::num_shards]
        done = self.processed_set()
        todo = [t for t in tasks if t[0] not in done]
        counts = {"done": 0, "skipped": 0, "error": 0}

        # With several devices, len(devices) encodes stay in flight: song
        # i's fetch waits until song i + len(devices) is dispatched, so the
        # round-robin placements run at once.
        inflight: deque = deque()
        max_inflight = len(self.devices) if self.devices else 1
        i = 0

        def tick():
            nonlocal i
            i += 1
            if i % stats_interval == 0:
                self.acc.save(self.stats_file)
            if verbose and i % 10 == 0:
                print(f"[preprocess] {i}/{len(todo)}")

        def flush_one():
            path, split, prepared, z = inflight.popleft()
            try:
                hr, lr, meta = self._finalize_encode(path, prepared, z)
                self._save_song(split, hr, lr, meta)
                self.acc.update(hr, lr)
                self._log({"path": path, "status": "done", "split": split})
                counts["done"] += 1
            except Exception as e:  # keep going on bad files (OOM etc.)
                self._log({"path": path, "status": "error", "msg": str(e)})
                counts["error"] += 1
                if verbose:
                    traceback.print_exc()
            tick()

        for path, split, prepared, err in self._prepared(todo, prefetch):
            try:
                if err is not None:
                    raise err
                inflight.append((path, split, prepared,
                                 self._dispatch_encode(prepared)))
            except ValueError as e:
                self._log({"path": path, "status": "skipped",
                           "reason": str(e)})
                counts["skipped"] += 1
                tick()
                continue
            except Exception as e:  # noqa: BLE001 - logged, run goes on
                self._log({"path": path, "status": "error", "msg": str(e)})
                counts["error"] += 1
                if verbose:
                    traceback.print_exc()
                tick()
                continue
            if len(inflight) >= max_inflight:
                flush_one()
        while inflight:
            flush_one()
        self.acc.save(self.stats_file)
        self.finalize_stats()
        return counts

    def refine_lr_only(self, low_sr: int, verbose: bool = True) -> int:
        """Re-encode ONLY the LR latents with another simulated low sample
        rate, in place (the reference's refine_dataset_lr_only.py:
        LOW_SR=32000 experiment), on the codec's device.  Logs ``redone``
        entries; the stats must be recomputed afterwards
        (``compute_separated_stats``)."""
        refined = 0
        codec = self.codec
        for split in ("train", "val"):
            for meta_path in sorted((self.out / split).glob("*.meta.json")):
                meta = json.loads(meta_path.read_text())
                src = meta.get("path")
                if not src or not Path(src).exists():
                    self._log({"path": src, "status": "refine_missing_src"})
                    continue
                audio, _, sr = self._prepare_song(src)
                x = self._at_high_sr(audio, sr, codec.device)
                _, z_lr = encode_windows(
                    codec.encoder, codec.quantizer, codec.cfg, self.cfg,
                    self._window_song(x), low_sr=low_sr)
                z_lr = z_lr.cpu().numpy()
                hop48 = self._win_samples / z_lr.shape[1]
                trim = int(self._overlap_samples / hop48)
                valid = int(self._valid_samples / hop48)
                full_lr = z_lr[:, trim : trim + valid, :].reshape(
                    -1, z_lr.shape[-1]
                )[: int(x.shape[0] / hop48)]
                base = str(meta_path).replace(".meta.json", "")
                np.save(base + ".lr.npy", full_lr.astype(np.float16))
                self._log({"path": src, "status": "redone",
                           "low_sr": low_sr})
                refined += 1
                if verbose and refined % 10 == 0:
                    print(f"[refine_lr] {refined} songs")
        return refined

    def normalize_stored_latents(self, verbose: bool = True) -> int:
        """The v2 generation's PASS 2 (scripts/prepare_dataset_v2.py:
        621-732): rewrite every saved latent as ``(z - mean) / std`` with
        the SCALAR separated HR/LR stats from pass 1, so the stored
        dataset is pre-normalized.  Downstream must then normalize with
        identity stats: this method rewrites both global-stats files to
        identity and keeps the pass-1 stats as
        ``global_stats_prenorm.json``.  Returns the number of songs
        rewritten.  (v3+ moved normalization into the training step, which
        is what the default pipeline does; this mode exists for dataset
        parity with v2-era artifacts.)"""
        s = self.acc.scalar_separated_stats()
        (self.out / "global_stats_prenorm.json").write_text(
            json.dumps(s, indent=2))
        n = 0
        for split in ("train", "val"):
            for hr_path in sorted((self.out / split).glob("*.hr.npy")):
                hr = np.load(hr_path).astype(np.float32)
                lr_path = Path(str(hr_path).replace(".hr.npy", ".lr.npy"))
                lr = np.load(lr_path).astype(np.float32)
                np.save(hr_path, ((hr - s["hr_mean"]) / s["hr_std"])
                        .astype(np.float16))
                np.save(lr_path, ((lr - s["lr_mean"]) / s["lr_std"])
                        .astype(np.float16))
                meta_path = Path(str(hr_path).replace(".hr.npy",
                                                      ".meta.json"))
                if meta_path.exists():
                    meta = json.loads(meta_path.read_text())
                    meta["normalized"] = True
                    meta_path.write_text(json.dumps(meta))
                n += 1
                if verbose and n % 50 == 0:
                    print(f"[normalize] {n} songs")
        c = self.acc.c
        identity = {
            "hr_mean": [0.0] * c, "hr_std": [1.0] * c,
            "lr_mean": [0.0] * c, "lr_std": [1.0] * c,
            "total_frames": int(self.acc.hr_n), "normalized_storage": True,
        }
        (self.out / "global_stats.json").write_text(
            json.dumps(identity, indent=2))
        (self.out / "global_stats_separated.json").write_text(
            json.dumps(identity, indent=2))
        return n

    def finalize_stats(self):
        (self.out / "global_stats.json").write_text(
            json.dumps(self.acc.combined_stats(), indent=2)
        )
        (self.out / "global_stats_separated.json").write_text(
            json.dumps(self.acc.separated_stats(), indent=2)
        )


def compute_separated_stats(data_dir: str, splits=("train",)) -> Dict:
    """Second-pass separated stats over saved latents: parity with
    recalculate_stats.py for datasets produced elsewhere."""
    acc = None
    for split in splits:
        for hr_path in sorted(Path(data_dir, split).glob("*.hr.npy")):
            hr = np.load(hr_path, mmap_mode="r")
            lr = np.load(str(hr_path).replace(".hr.npy", ".lr.npy"),
                         mmap_mode="r")
            if acc is None:
                acc = StatsAccumulator(hr.shape[-1])
            acc.update(np.asarray(hr), np.asarray(lr))
    if acc is None:
        raise ValueError(f"no latents found under {data_dir}")
    stats = acc.separated_stats()
    Path(data_dir, "global_stats_separated.json").write_text(
        json.dumps(stats, indent=2)
    )
    return stats
