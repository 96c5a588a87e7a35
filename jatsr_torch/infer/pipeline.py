"""Chunked super-resolution with crossfade stitching: audio or latent in,
latent or audio out.

Port of the JAX package's ``infer/pipeline.py``: ``super_resolve_latent``
(chunk, normalize, sample in groups, denormalize, crossfade), the
segmented ``decode_latent``, ``encode_lr_audio`` (resample to the codec's
rate, encode), ``super_resolve_audio`` and ``super_resolve_latent_to_audio``
(sampling and decoding interleaved: each decode segment is enqueued as
soon as its frames are final).  The whole chain stays on the pipeline's
device.

Serving on a mesh (``mesh=``, a ``(D, M)`` mesh over D x M processes, one
a card): every rank runs the pipeline on the same input; each group of
chunks is padded to a multiple of D with null chunks (zero condition, zero
noise), each data rank samples its span of the group (CFG on its own rows),
and the rows are gathered (``all_gather`` over the data dim) on every rank.
At M > 1 the M ranks of a model group take the same rows and the same
noise through a tensor-parallel ``DiT`` or ``DenseDiT`` built on the same
mesh, whose
forward ends with the one-card output on each of them.  The initial noise is
drawn for the group as one card draws it, so the output is the single-card
output.  Audio input is encoded on every rank and data rank 0's latent is
broadcast; the interleaved decode of :meth:`super_resolve_latent_to_audio`
runs on rank 0 alone (the others return None): the DAC stays whole there.  ``decode_devices``: cards
of this process that take the decodes round robin, one decoder weight copy
a card (:func:`split_serve_devices` partitions a device list).

The initial noise: under ``chunk_noise="per_chunk"`` (the default),
``super_resolve_latent`` draws each chunk's from (seed, chunk); under
``"batch"`` each group draws one from (seed, group) through
:func:`group_noise`.  ``super_resolve_latent_to_audio`` always draws per
group, as the JAX package does, so it equals
``decode_latent(super_resolve_latent_device(...))`` under ``"batch"``
only.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import SamplerConfig
from ..models.dac import DAC
from ..models.dit import DenseDiT, DiT, adaln_tables
from ..ops.resample import resample
from ..parallel.distributed import DataGroup
from ..parallel.mesh import model_rank, model_size
from ..sampling import FlowSampler
from ..sampling.flow import linspace_f32
from ..train.step import Normalizer
from ..utils.device import resolve_device


def chunk_plan(total_frames: int, chunk_frames: int,
               overlap_frames: int) -> List[Tuple[int, int]]:
    """[(start, end)] covering ``total_frames``."""
    if total_frames <= chunk_frames:
        return [(0, total_frames)]
    stride = chunk_frames - overlap_frames
    n = (total_frames - overlap_frames + stride - 1) // stride
    return [(i * stride, min(i * stride + chunk_frames, total_frames))
            for i in range(n)]


def _stream_seed(*words: int) -> int:
    """A 64-bit generator seed that is a pure function of ``words``."""
    return int(np.random.SeedSequence(list(words))
               .generate_state(1, np.uint64)[0])


def _per_chunk_noise(seed: int, n: int, frames: int, channels: int,
                     device) -> torch.Tensor:
    """``[n, frames, channels]`` initial noise; slice i is a pure function
    of (seed, i), so chunked outputs do not depend on how chunks are
    grouped.  Each chunk draws from its own generator, seeded from
    ``(seed, i)`` through numpy's SeedSequence."""
    out = torch.empty((n, frames, channels), dtype=torch.float32,
                      device=device)
    for i in range(n):
        g = torch.Generator(device=device)
        g.manual_seed(_stream_seed(seed, i))
        out[i] = torch.randn((frames, channels), generator=g,
                             dtype=torch.float32, device=device)
    return out


def group_noise(seed: int, gi: int, shape, device) -> torch.Tensor:
    """The initial noise of chunk group ``gi`` where chunks draw no noise
    of their own: one fp32 draw of the group's ``shape``, a pure function
    of (seed, gi)."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, gi, 1))
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                       device=device)


def split_serve_devices(devices=None, n_decode: int = 1):
    """Partition devices (this host's cards by default) into ``(sampler
    devices, decode devices)``: the last ``n_decode`` decode
    (``InferencePipeline(decode_devices=...)``), the rest sample."""
    devices = list(devices if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if not 0 < n_decode < len(devices):
        raise ValueError(
            f"n_decode={n_decode} must leave >=1 sampler device of "
            f"{len(devices)}")
    return devices[:-n_decode], devices[-n_decode:]


def crossfade_chunks(chunks: List[torch.Tensor],
                     overlap_frames: int) -> torch.Tensor:
    """Linear fade-out/fade-in stitch of ``[T_i, C]`` chunks, on their
    device."""
    if not chunks:
        raise ValueError("no chunks")
    result = chunks[0]
    for cur in chunks[1:]:
        if overlap_frames > 0 and result.shape[0] >= overlap_frames:
            fade_out = _ramp(1.0, 0.0, overlap_frames, result.device)
            fade_in = _ramp(0.0, 1.0, overlap_frames, result.device)
            blended = (result[-overlap_frames:] * fade_out
                       + cur[:overlap_frames] * fade_in)
            result = torch.cat([result[:-overlap_frames], blended,
                                cur[overlap_frames:]])
        else:
            result = torch.cat([result, cur])
    return result


def _ramp(start: float, stop: float, n: int, device) -> torch.Tensor:
    return torch.from_numpy(linspace_f32(start, stop, n)[:, None]).to(device)


class InferencePipeline:
    """Raw LR latent -> generated HR latent -> 44.1 kHz audio.

    Args:
        model: the port's int8 serving :class:`DiT` or the bf16
            :class:`DenseDiT`.
        normalizer: latent statistics (:class:`Normalizer`).
        codec: the :class:`DAC` (needed for audio; audio input needs its
            encoder too).
        sampler_cfg: chunking and sampler settings.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
        mesh: None, or a ``(D, M)`` mesh (``parallel.make_mesh``): the
            chunks sampled data-parallel over its D data ranks; at M > 1
            ``model`` must be built on the same mesh (the int8 ``DiT`` or
            the ``DenseDiT``, tensor-parallel over its M model ranks).
        decode_devices: None, or devices that take the decodes round robin
            (each holding a copy of the decoder's weights).
    """

    # Class-level defaults, so that a decode-only pipeline built without
    # __init__ (codec, hop and device set by hand) decodes in place.
    decode_devices = None
    _decode_rr = 0

    def __init__(self, model: DiT | DenseDiT, normalizer: Normalizer,
                 codec: Optional[DAC] = None,
                 sampler_cfg: Optional[SamplerConfig] = None,
                 data_sample_rate: int = 44100, hop_length: int = 512,
                 device="cuda", mesh=None, decode_devices=None):
        self.device = resolve_device(device)
        M = model_size(mesh)
        if M > 1 and getattr(getattr(model, "tp", None), "size", 1) != M:
            raise ValueError(f"a mesh with a model axis of {M} needs the "
                             f"model built on it: DiT(..., mesh=mesh) or "
                             f"DenseDiT(..., mesh=mesh)")
        self._dp = DataGroup.of(mesh)
        self.primary = self._dp is None or (self._dp.rank == 0
                                            and model_rank(mesh) == 0)
        self.decode_devices = ([resolve_device(d) for d in decode_devices]
                               if decode_devices else None)
        self._decoders = {}
        self._decode_rr = 0
        self.model = model
        self.norm = normalizer
        self.codec = codec
        self.cfg = sampler_cfg or SamplerConfig()
        self.sr = data_sample_rate
        self.hop = hop_length
        if self.cfg.chunk_noise not in ("per_chunk", "batch"):
            raise ValueError(f"unknown chunk_noise {self.cfg.chunk_noise!r}")
        self.sampler = FlowSampler(
            lambda z, t, c, mod=None: model(z, t, c, adaln_mod=mod),
            self.cfg, adaln_fn=lambda tv: adaln_tables(model, tv),
            device=self.device)

    def _sample(self, g, num_steps, cfg_scale, z0) -> torch.Tensor:
        """One group of chunks through the sampler.  Under a mesh the group
        is padded to a multiple of the data dim with null chunks, each rank
        samples its span, and the spans are gathered."""
        if self._dp is None or self._dp.size == 1:
            return self.sampler(g, num_steps, cfg_scale, z0=z0)
        n = g.shape[0]
        pad = (0, 0, 0, 0, 0, (-n) % self._dp.size)
        g, z0 = F.pad(g, pad), F.pad(z0, pad)
        rows = self._dp.rows(g.shape[0])
        mine = self.sampler(g[rows], num_steps, cfg_scale, z0=z0[rows])
        return self._dp.gather_rows(mine)[:n]

    def _decode(self, batch: torch.Tensor) -> torch.Tensor:
        """``[S, L, C]`` -> ``[S, L * hop, 1]`` on the pipeline's device:
        the codec's decode, or on the next of ``decode_devices`` round
        robin (its decoder copy made at first use)."""
        if self.decode_devices is None:
            return self.codec.decode(batch)
        dev = self.decode_devices[self._decode_rr % len(self.decode_devices)]
        self._decode_rr += 1
        if dev not in self._decoders:
            self._decoders[dev] = self.codec.decoder_copy(dev)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            wav = self._decoders[dev].decode(batch.to(dev))
        return wav.to(self.device)

    @property
    def chunk_frames(self) -> int:
        return int(self.cfg.chunk_duration * self.sr / self.hop)  # 1378

    @property
    def overlap_frames(self) -> int:
        return int(self.cfg.overlap_duration * self.sr / self.hop)  # 172

    def super_resolve_latent(self, lr_latent, seed: int = 0,
                             num_steps: Optional[int] = None,
                             cfg_scale: Optional[float] = None,
                             max_batch: int = 0) -> np.ndarray:
        """``[T, C]`` raw LR latent -> ``[T, C]`` generated raw HR latent
        (host copy of :meth:`super_resolve_latent_device`)."""
        return self.super_resolve_latent_device(
            lr_latent, seed, num_steps, cfg_scale, max_batch).cpu().numpy()

    def _chunk_cond(self, lr_latent, plan) -> torch.Tensor:
        """``[n_chunks, chunk_frames, C]`` normalized condition chunks.
        Normalizes first, then zero-pads the short tail chunk: zeros in
        normalized space are the CFG null token."""
        CF = self.chunk_frames
        lat = torch.as_tensor(lr_latent, dtype=torch.float32).to(self.device)
        lat_n = self.norm.norm_lr(lat[None])[0]
        tail = plan[-1][1] - plan[-1][0]
        if tail < CF:
            lat_n = F.pad(lat_n, (0, 0, 0, CF - tail))
        return torch.stack([lat_n[s: s + CF] for s, _ in plan])

    @torch.no_grad()
    def super_resolve_latent_device(self, lr_latent, seed: int = 0,
                                    num_steps: Optional[int] = None,
                                    cfg_scale: Optional[float] = None,
                                    max_batch: int = 0) -> torch.Tensor:
        """As :meth:`super_resolve_latent`, result left on the device.

        Samples the chunks in groups of ``max_batch`` (0: one group),
        denormalizes and crossfades.  With ``pad_tail_group`` and per-chunk
        noise, a short tail group is padded with null chunks (zero
        condition, zero noise) to ``max_batch``; their outputs are dropped.
        """
        T = lr_latent.shape[0]
        plan = chunk_plan(T, self.chunk_frames, self.overlap_frames)
        cond = self._chunk_cond(lr_latent, plan)
        z0_all = None
        if self.cfg.chunk_noise == "per_chunk":
            z0_all = _per_chunk_noise(seed, len(plan), self.chunk_frames,
                                      cond.shape[-1], self.device)
        step = max_batch if max_batch > 0 else len(plan)
        outs = []
        for gi, s_g in enumerate(range(0, len(plan), step)):
            g = cond[s_g:s_g + step]
            n_real = g.shape[0]
            if z0_all is None:
                z0 = group_noise(seed, gi, g.shape, self.device)
            else:
                z0 = z0_all[s_g:s_g + step]
                if self.cfg.pad_tail_group and gi > 0 and n_real < max_batch:
                    pad = (0, 0, 0, 0, 0, max_batch - n_real)
                    g, z0 = F.pad(g, pad), F.pad(z0, pad)
            gen = self._sample(g, num_steps, cfg_scale, z0)[:n_real]
            outs.append(self.norm.denorm_hr(gen))
        gen_all = torch.cat(outs)
        chunks = [gen_all[i, : e - s] for i, (s, e) in enumerate(plan)]
        return crossfade_chunks(chunks, self.overlap_frames)[:T]

    def encode_lr_audio(self, audio, sr: int) -> np.ndarray:
        """Mono audio ``[T]`` at any rate -> LR latent ``[T', C]`` on the
        host (resampled to the codec's rate, then encoded)."""
        return self._encode_lr_audio_device(audio, sr).cpu().numpy()

    @torch.no_grad()
    def _encode_lr_audio_device(self, audio, sr: int) -> torch.Tensor:
        if self.codec is None:
            raise ValueError("audio input needs a codec")
        x = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        x = x.reshape(1, -1, 1)
        if sr != self.sr:
            x = resample(x, sr, self.sr)
        z, _ = self.codec.encode(x)
        return z[0]

    def super_resolve_audio(self, audio, sr: int, seed: int = 0,
                            num_steps: Optional[int] = None,
                            cfg_scale: Optional[float] = None,
                            max_batch: int = 8) -> np.ndarray:
        """Mono LR audio at any rate -> generated full-band audio at the
        codec's rate, on the host: resample, encode, then
        :meth:`super_resolve_latent_to_audio`."""
        if self.codec is None:
            raise ValueError("audio output needs a codec")
        lr_latent = self._encode_lr_audio_device(audio, sr)
        if self._dp is not None and self._dp.size > 1:
            self._dp.broadcast_(lr_latent)  # one condition on every rank
        return self.super_resolve_latent_to_audio(
            lr_latent, seed, num_steps, cfg_scale, max_batch=max_batch)

    @torch.no_grad()
    def super_resolve_latent_to_audio(self, lr_latent, seed: int = 0,
                                      num_steps: Optional[int] = None,
                                      cfg_scale: Optional[float] = None,
                                      max_batch: int = 8,
                                      segment_frames: int = 2756,
                                      ctx_frames: int = 64) -> np.ndarray:
        """``[T, C]`` LR latent -> mono audio on the host, with sampling and
        decoding interleaved: the crossfade runs incrementally as each
        group's chunks come out of the sampler, and every decode segment
        whose frames are final is enqueued before the next group's sampler
        call.  The arithmetic is that of :func:`crossfade_chunks` and the
        windows those of :meth:`decode_latent`.

        Each group draws its initial noise from (seed, group)
        (:func:`group_noise`) whatever ``chunk_noise`` is, as the JAX
        package does.  A short input (one chunk, or one decode segment)
        takes ``decode_latent(super_resolve_latent_device(...))``.  Under a
        mesh rank 0 decodes and every other rank returns None."""
        if self.codec is None:
            raise ValueError("audio output needs a codec")
        T = lr_latent.shape[0]
        CF, OV, hop = self.chunk_frames, self.overlap_frames, self.hop
        plan = chunk_plan(T, CF, OV)
        if T <= segment_frames + 2 * ctx_frames or len(plan) < 2:
            gen = self.super_resolve_latent_device(
                lr_latent, seed, num_steps, cfg_scale, max_batch)
            return (self.decode_latent(gen, segment_frames, ctx_frames)
                    if self.primary else None)

        cond = self._chunk_cond(lr_latent, plan)
        segs = self._decode_plan(T, segment_frames, ctx_frames)
        L = segment_frames + 2 * ctx_frames
        fade_out = _ramp(1.0, 0.0, OV, self.device)
        fade_in = _ramp(0.0, 1.0, OV, self.device)
        mb = max_batch if max_batch > 0 else len(plan)
        stitched = None  # frames [0, done): final values
        pending = None   # the trailing OV frames the next chunk blends into
        pieces, next_seg, ci = [], 0, 0
        for gi, i in enumerate(range(0, len(plan), mb)):
            g = cond[i:i + mb]
            z0 = group_noise(seed, gi, g.shape, self.device)
            gen = self.norm.denorm_hr(
                self._sample(g, num_steps, cfg_scale, z0))
            for j, (s, e) in enumerate(plan[i:i + mb]):
                cur = gen[j, : e - s]
                if stitched is None:
                    stitched, pending = cur[:-OV], cur[-OV:]
                else:
                    blended = pending * fade_out + cur[:OV] * fade_in
                    body = torch.cat([blended, cur[OV:]])
                    if ci == len(plan) - 1:
                        stitched, pending = torch.cat([stitched, body]), None
                    else:
                        stitched = torch.cat([stitched, body[:-OV]])
                        pending = body[-OV:]
                ci += 1
            done = stitched.shape[0]
            while (self.primary and next_seg < len(segs)
                   and segs[next_seg][3] <= done):
                s, e, lo, hi = segs[next_seg]
                seg = F.pad(stitched[lo:hi], (0, 0, 0, L - (hi - lo)))
                wav = self._decode(seg[None])[0, :, 0]
                pieces.append(wav[(s - lo) * hop: (e - lo) * hop])
                next_seg += 1
        assert pending is None and stitched.shape[0] == T
        if not self.primary:
            return None
        assert next_seg == len(segs)
        return torch.cat(pieces).cpu().numpy()

    @staticmethod
    def _decode_plan(T: int, segment_frames: int, ctx_frames: int):
        """[(s, e, lo, hi)] decode windows over a T-frame latent; the final
        window is anchored to end exactly at T."""
        L = segment_frames + 2 * ctx_frames
        segs = []
        for s in range(0, T, segment_frames):
            e = min(T, s + segment_frames)
            lo = max(0, s - ctx_frames)
            hi = min(T, e + ctx_frames)
            if hi == T:
                lo = max(0, T - L)
            segs.append((s, e, lo, hi))
        return segs

    def decode_latent(self, latent, segment_frames: int = 2756,
                      ctx_frames: int = 64,
                      decode_batch: int = 1) -> np.ndarray:
        """``[T, C]`` latent -> mono audio on the host."""
        pieces = self.decode_latent_pieces(latent, segment_frames, ctx_frames,
                                           decode_batch)
        return torch.cat(pieces).cpu().numpy()

    @torch.no_grad()
    def decode_latent_pieces(self, latent, segment_frames: int = 2756,
                             ctx_frames: int = 64,
                             decode_batch: int = 1) -> List[torch.Tensor]:
        """The ordered device wav pieces of :meth:`decode_latent`.

        Long latents decode in ``segment_frames`` segments with
        ``ctx_frames`` of context each side, all padded to one length;
        ``decode_batch`` segments go through each decoder call."""
        if self.codec is None:
            raise ValueError("decode needs a codec")
        z = torch.as_tensor(latent, dtype=torch.float32).to(self.device)
        T = z.shape[0]
        hop = self.hop
        if segment_frames <= 0 or T <= segment_frames + 2 * ctx_frames:
            return [self._decode(z[None])[0, :, 0]]
        L = segment_frames + 2 * ctx_frames
        plan = self._decode_plan(T, segment_frames, ctx_frames)
        segs = [F.pad(z[lo:hi], (0, 0, 0, L - (hi - lo)))
                for _, _, lo, hi in plan]
        nb = max(1, decode_batch)
        pieces = []
        for i in range(0, len(segs), nb):
            group = segs[i: i + nb]
            batch = torch.stack(group)
            if len(group) < nb:
                batch = F.pad(batch, (0, 0, 0, 0, 0, nb - len(group)))
            wavs = self._decode(batch)
            for j in range(len(group)):
                s, e, lo, hi = plan[i + j]
                pieces.append(wavs[j, (s - lo) * hop: (e - lo) * hop, 0])
        return pieces
