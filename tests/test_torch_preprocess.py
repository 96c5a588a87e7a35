"""The port's data preparation against the JAX package's.

``jatsr_torch.data.preprocess.PreprocessPipeline`` and the JAX package's run
on the same WAVs with the same codec weights (``tests/test_data_pipeline.py``'s
tiny codec and ``DataConfig``; the port's ``DAC`` carries the weights
across by ``models/from_jax.py:dac_tree_from_jax``): the same
files, the same log lines and metadata, and the latents and stats within
the bounds below, in each chunking mode; resume, sharding,
``normalize_stored_latents``, ``refine_lr_only``, ``compute_separated_stats``
and the round-robin over two devices.  One song is at 12 kHz, so that the
input resample to ``high_sr`` runs too.

Bounds.
- Latents: the encoder and RVQ agree within ``1e-6 x max |z|``
  (``tests/test_torch_dac.py``'s encoder bound; the codes equal), and the
  stored values are fp16, so a value near a rounding point can land one
  fp16 ulp apart: ``|port - jax| <= ulp_fp16(|jax|) + 1e-6 x max |jax|``.
- Stats files: ``rtol 1e-5`` (float64 sums of the fp16 latents; where the
  latents are equal, so are they).
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import DataConfig as JaxDataConfig
from jatsr_tpu.data import PreprocessPipeline as JaxPipeline
from jatsr_tpu.data import compute_separated_stats as jax_separated_stats
from jatsr_tpu.models.dac import DAC as JaxDAC
from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
from jatsr_torch.configs import DataConfig
from jatsr_torch.data import (LatentDataset, PreprocessPipeline,
                              compute_separated_stats, load_stats)
from jatsr_torch.models.dac import DAC, DACConfig, init_params
from jatsr_torch.utils.audio_io import save_wav

CODEC = dict(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=16,
             decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
             codebook_dim=4)
DATA = dict(high_sr=8000, low_sr=4000, dac_sample_rate=8000,
            chunk_duration=0.5, overlap_duration=0.1, min_duration=0.2,
            val_ratio=0.5)
MODES = {"overlap": {}, "plain": dict(chunking="plain", overlap_duration=0.0),
         "whole": dict(chunking="whole")}
STATS = ("global_stats.json", "global_stats_separated.json")


def _make_wavs(d: Path):
    """``test_data_pipeline.py``'s four songs and short file, and a fifth
    song at 12 kHz."""
    d.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(0)
    for i, sr in enumerate((8000, 8000, 8000, 8000, 12000)):
        secs = 0.8 + 0.4 * i
        t = np.arange(int(sr * secs)) / sr
        audio = 0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        audio += 0.05 * rs.randn(len(t))
        save_wav(d / f"song_{i}.wav", audio.astype(np.float32), sr)
    save_wav(d / "short.wav", np.zeros(800, np.float32), 8000)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One torch CPU thread in this module: its tensors are tiny, and a
    thread pool spinning beside the prefetch thread and the other test
    workers' pools costs seconds a run (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codecs():
    """One set of seeded weights (the port's ``init_params``, JAX's layout)
    in both codecs."""
    params = init_params(DACConfig(**CODEC), 0)
    jdac = JaxDAC(jax.tree_util.tree_map(jnp.asarray, params),
                  JaxDACConfig(**CODEC))
    return jdac, DAC(params, DACConfig(**CODEC), device="cpu")


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    _make_wavs(d)
    return d


def _run(kind, codecs, src, out, mode="overlap", **kw):
    jdac, tdac = codecs
    if kind == "jax":
        pipe = JaxPipeline(jdac, dataclasses.replace(
            JaxDataConfig(**DATA), **MODES[mode]), str(out))
    else:
        pipe = PreprocessPipeline(tdac, dataclasses.replace(
            DataConfig(**DATA), **MODES[mode]), str(out),
            devices=kw.pop("devices", None))
    return pipe, pipe.run([str(src)], verbose=False, **kw)


@pytest.fixture(scope="module")
def runs(codecs, src, tmp_path_factory):
    """Both pipelines in each chunking mode: ``{mode: (jax_out, port_out,
    jax_counts, port_counts)}``."""
    got = {}
    for mode in MODES:
        root = tmp_path_factory.mktemp(mode)
        (_, jc), (_, tc) = (_run(k, codecs, src, root / k, mode)
                            for k in ("jax", "torch"))
        got[mode] = (root / "jax", root / "torch", jc, tc)
    return got


def _latents(out: Path):
    return {f"{p.parent.name}/{p.name}": np.load(p)
            for split in ("train", "val")
            for p in sorted((out / split).glob("*.npy"))}


def assert_latents_close(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape
    g, w = got.astype(np.float64), want.astype(np.float64)
    bound = (np.spacing(np.abs(want)).astype(np.float64)
             + 1e-6 * np.abs(w).max())
    assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


def _log(out: Path):
    return [json.loads(line) for line in
            (out / "processed_files.jsonl").read_text().splitlines()]


def _rel(out: Path, entries):
    """Log entries with their paths relative to the source directory."""
    return sorted((Path(e["path"]).name, e["status"], e.get("split"),
                   e.get("reason")) for e in entries)


@pytest.mark.parametrize("mode", list(MODES))
def test_latents_match_jax(runs, mode):
    jout, tout, jc, tc = runs[mode]
    assert tc == jc == {"done": 5, "skipped": 1, "error": 0}
    want, got = _latents(jout), _latents(tout)
    assert sorted(got) == sorted(want) and len(got) == 10
    for name in want:
        assert_latents_close(got[name], want[name])
        assert got[name].shape[1] == DACConfig(**CODEC).latent_dim


@pytest.mark.parametrize("mode", list(MODES))
def test_stats_files_match_jax(runs, mode):
    jout, tout, _, _ = runs[mode]
    for name in STATS:
        want = json.loads((jout / name).read_text())
        got = json.loads((tout / name).read_text())
        assert sorted(got) == sorted(want)
        assert got["total_frames"] == want["total_frames"]
        for k in ("hr_mean", "hr_std", "lr_mean", "lr_std"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    want, got = np.load(jout / "running_stats.npz"), np.load(
        tout / "running_stats.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_same_files_log_lines_and_metadata(runs, mode):
    jout, tout, _, _ = runs[mode]
    files = {o: sorted(str(p.relative_to(o)) for p in o.rglob("*")
                       if p.is_file()) for o in (jout, tout)}
    assert files[tout] == files[jout]
    assert _rel(tout, _log(tout)) == _rel(jout, _log(jout))
    for meta in (jout / "train").glob("*.meta.json"):
        want = json.loads(meta.read_text())
        got = json.loads((tout / "train" / meta.name).read_text())
        assert got == want
        assert got["frames"] == np.load(
            tout / "train" / meta.name.replace(".meta.json", ".hr.npy")
        ).shape[0]


def test_the_port_reads_what_it_writes(runs):
    _, tout, _, _ = runs["overlap"]
    hm, hs, lm, ls = load_stats(str(tout / "global_stats_separated.json"))
    assert hm.shape == (DACConfig(**CODEC).latent_dim,) and (hs > 0).all()
    hr, lr = LatentDataset(str(tout), "train", target_frames=40,
                           multiplier=2)[0]
    assert hr.shape == lr.shape == (40, DACConfig(**CODEC).latent_dim)


def test_resume_encodes_nothing(runs, codecs, src, tmp_path):
    _, tout, _, _ = runs["overlap"]
    out = tmp_path / "again"
    shutil.copytree(tout, out)
    pipe, counts = _run("torch", codecs, src, out)
    assert counts == {"done": 0, "skipped": 1, "error": 0}
    assert len(pipe.processed_set()) == 5
    # The accumulator resumed from running_stats.npz: the stats stand.
    for name in STATS:
        assert json.loads((out / name).read_text()) == json.loads(
            (tout / name).read_text())


def test_sharding_covers_every_song(runs, codecs, src, tmp_path):
    _, tout, _, _ = runs["overlap"]
    names, total = set(), 0
    for idx in range(2):
        out = tmp_path / f"shard{idx}"
        _, counts = _run("torch", codecs, src, out, num_shards=2,
                         shard_index=idx)
        total += counts["done"] + counts["skipped"]
        for p in out.rglob("*.hr.npy"):
            names.add(p.name)
            split = p.parent.name
            np.testing.assert_array_equal(np.load(p),
                                          np.load(tout / split / p.name))
    assert total == 6 and len(names) == 5


def test_two_devices_round_robin_bit_equal_to_one(runs, codecs, src,
                                                  tmp_path):
    _, tout, _, tc = runs["overlap"]
    cpu = torch.device("cpu")
    pipe, counts = _run("torch", codecs, src, tmp_path / "rr",
                        devices=[cpu, cpu])
    assert counts == tc and pipe._enc_rr == 5
    want, got = _latents(tout), _latents(tmp_path / "rr")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    for name in STATS:
        assert json.loads((tmp_path / "rr" / name).read_text()) == \
            json.loads((tout / name).read_text())


def test_serial_run_equals_the_prefetched_one(runs, codecs, src, tmp_path):
    _, tout, _, tc = runs["overlap"]
    _, counts = _run("torch", codecs, src, tmp_path / "serial",
                     prefetch=False)
    assert counts == tc
    want, got = _latents(tout), _latents(tmp_path / "serial")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def _copies(runs, tmp_path, what):
    jout, tout, _, _ = runs["overlap"]
    return (shutil.copytree(jout, tmp_path / f"jax_{what}"),
            shutil.copytree(tout, tmp_path / f"torch_{what}"))


def _pipes(codecs, jout, tout):
    jdac, tdac = codecs
    return (JaxPipeline(jdac, JaxDataConfig(**DATA), str(jout)),
            PreprocessPipeline(tdac, DataConfig(**DATA), str(tout)))


def test_normalize_stored_latents_matches_jax(runs, codecs, tmp_path):
    jout, tout = _copies(runs, tmp_path, "norm")
    jpipe, tpipe = _pipes(codecs, jout, tout)
    want = jpipe.acc.scalar_separated_stats()
    got = tpipe.acc.scalar_separated_stats()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert tpipe.normalize_stored_latents(verbose=False) == \
        jpipe.normalize_stored_latents(verbose=False) == 5
    raw = _latents(runs["overlap"][0])
    w, g = _latents(jout), _latents(tout)
    for name in w:
        # (z - m) / s of latents within the bound above, by stats within
        # rtol 1e-5, rounded to fp16 again.
        key = "hr" if name.endswith(".hr.npy") else "lr"
        m, sd = want[f"{key}_mean"], want[f"{key}_std"]
        z = raw[name].astype(np.float64)
        post = w[name].astype(np.float64)
        bound = ((np.spacing(np.abs(raw[name])) + 1e-6 * np.abs(z).max())
                 / sd + np.spacing(np.abs(w[name]))
                 + 1e-5 * (np.abs(post) + abs(m) / sd))
        assert (np.abs(g[name].astype(np.float64) - post) <= bound).all()
    for name in STATS + ("global_stats_prenorm.json",):
        want = json.loads((jout / name).read_text())
        got = json.loads((tout / name).read_text())
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for meta in (jout / "train").glob("*.meta.json"):
        assert json.loads((tout / "train" / meta.name).read_text()) == \
            json.loads(meta.read_text())


def test_refine_lr_only_matches_jax(runs, codecs, tmp_path):
    """On the first song of each split (the JAX refinement runs eagerly,
    op by op, and takes seconds a song)."""
    jout, tout = _copies(runs, tmp_path, "refine")
    for out in (jout, tout):
        for split in ("train", "val"):
            for meta in sorted((out / split).glob("*.meta.json"))[1:]:
                for p in out.joinpath(split).glob(
                        meta.name.replace(".meta.json", ".*")):
                    p.unlink()
    jpipe, tpipe = _pipes(codecs, jout, tout)
    before = _latents(tout)
    assert tpipe.refine_lr_only(2000, verbose=False) == \
        jpipe.refine_lr_only(2000, verbose=False) == 2
    w, g = _latents(jout), _latents(tout)
    for name in w:
        if name.endswith(".hr.npy"):
            np.testing.assert_array_equal(g[name], before[name])
        else:
            assert not np.array_equal(g[name], before[name])
            assert_latents_close(g[name], w[name])
    redone = [e for e in _log(tout) if e["status"] == "redone"]
    assert len(redone) == 2 and all(e["low_sr"] == 2000 for e in redone)
    assert _rel(tout, _log(tout)) == _rel(jout, _log(jout))


def test_compute_separated_stats_matches_jax(runs, tmp_path):
    jout, tout = _copies(runs, tmp_path, "stats")
    for splits in (("train",), ("train", "val")):
        want = jax_separated_stats(str(jout), splits=splits)
        got = compute_separated_stats(str(jout), splits=splits)
        assert got == want  # the same numpy on the same files
        mine = compute_separated_stats(str(tout), splits=splits)
        for k in ("hr_mean", "hr_std", "lr_mean", "lr_std"):
            np.testing.assert_allclose(mine[k], want[k], rtol=1e-5)
    with pytest.raises(ValueError, match="no latents"):
        compute_separated_stats(str(tmp_path / "absent"))
