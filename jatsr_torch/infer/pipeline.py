"""Chunked latent super-resolution with crossfade stitching, and the
segmented DAC decode.

Port of the JAX package's ``infer/pipeline.py`` on the serving path that
``bench.py --end-to-end`` measures: ``super_resolve_latent_device`` then
``decode_latent_pieces``.  The whole chain (normalize, chunk, sample,
denormalize, crossfade, decode) stays on the pipeline's device.
``super_resolve_latent_to_audio``, audio encode, meshes and
``decode_devices`` come in later slices.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import SamplerConfig
from ..models.dac import DAC
from ..models.dit import DiT, adaln_tables
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
        g.manual_seed(int(np.random.SeedSequence([seed, i])
                          .generate_state(1, np.uint64)[0]))
        out[i] = torch.randn((frames, channels), generator=g,
                             dtype=torch.float32, device=device)
    return out


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
        model: the port's :class:`DiT`.
        normalizer: latent statistics (:class:`Normalizer`).
        codec: the decode-only :class:`DAC` (needed for audio).
        sampler_cfg: chunking and sampler settings.
        device: ``"cuda"`` (default) or an explicit ``"cpu"``.
    """

    def __init__(self, model: DiT, normalizer: Normalizer,
                 codec: Optional[DAC] = None,
                 sampler_cfg: Optional[SamplerConfig] = None,
                 data_sample_rate: int = 44100, hop_length: int = 512,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.norm = normalizer
        self.codec = codec
        self.cfg = sampler_cfg or SamplerConfig()
        self.sr = data_sample_rate
        self.hop = hop_length
        if self.cfg.chunk_noise != "per_chunk":
            raise NotImplementedError(
                "chunk_noise='batch' (the whole-batch draw) comes in a later "
                "slice")
        if self.cfg.pad_tail_group:
            raise NotImplementedError(
                "pad_tail_group comes with the CUDA-graph slice")
        self.sampler = FlowSampler(
            lambda z, t, c, mod=None: model(z, t, c, adaln_mod=mod),
            self.cfg, adaln_fn=lambda tv: adaln_tables(model, tv),
            device=self.device)

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

    @torch.no_grad()
    def super_resolve_latent_device(self, lr_latent, seed: int = 0,
                                    num_steps: Optional[int] = None,
                                    cfg_scale: Optional[float] = None,
                                    max_batch: int = 0) -> torch.Tensor:
        """As :meth:`super_resolve_latent`, result left on the device.

        Normalizes first, then zero-pads the short tail chunk (zeros in
        normalized space are the CFG null token), samples the chunks in
        groups of ``max_batch`` (0: one group), denormalizes and
        crossfades."""
        T = lr_latent.shape[0]
        plan = chunk_plan(T, self.chunk_frames, self.overlap_frames)
        CF = self.chunk_frames
        lat = torch.as_tensor(lr_latent, dtype=torch.float32).to(self.device)
        lat_n = self.norm.norm_lr(lat[None])[0]
        tail = plan[-1][1] - plan[-1][0]
        if tail < CF:
            lat_n = F.pad(lat_n, (0, 0, 0, CF - tail))
        cond = torch.stack([lat_n[s: s + CF] for s, _ in plan])
        z0_all = _per_chunk_noise(seed, len(plan), CF, lat_n.shape[-1],
                                  self.device)
        step = max_batch if max_batch > 0 else len(plan)
        outs = []
        for s_g in range(0, len(plan), step):
            gen = self.sampler(cond[s_g:s_g + step], num_steps, cfg_scale,
                               z0=z0_all[s_g:s_g + step])
            outs.append(self.norm.denorm_hr(gen))
        gen_all = torch.cat(outs)
        chunks = [gen_all[i, : e - s] for i, (s, e) in enumerate(plan)]
        return crossfade_chunks(chunks, self.overlap_frames)[:T]

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
            return [self.codec.decode(z[None])[0, :, 0]]
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
            wavs = self.codec.decode(batch)
            for j in range(len(group)):
                s, e, lo, hi = plan[i + j]
                pieces.append(wavs[j, (s - lo) * hop: (e - lo) * hop, 0])
        return pieces
