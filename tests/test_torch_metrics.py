"""The port's audio metrics and plots against the JAX package's.

``jatsr_torch.metrics`` is float64 numpy on the host, as the JAX package's
``metrics``: every function equals it on the same inputs to 1e-12 relative.
The plots write PNGs here; without matplotlib the module still imports and
a call raises ``ImportError`` naming it.
"""

import sys

import numpy as np
import pytest

from jatsr_tpu import metrics as jm
from jatsr_tpu.utils import layout as jlayout
from jatsr_torch import metrics as tm
from jatsr_torch.metrics import plots
from jatsr_torch.utils import layout as tlayout

RTOL = 1e-12
SR = 44100


@pytest.fixture(scope="module")
def signals():
    """A tone with noise and its low-passed copy (the band a super-resolver
    regenerates), 0.4 s at 44.1 kHz, from a seed."""
    rng = np.random.default_rng(0)
    t = np.arange(int(0.4 * SR)) / SR
    gt = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 9000 * t)
          + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
    spec = np.fft.rfft(gt)
    spec[np.fft.rfftfreq(len(gt), 1 / SR) > 8000] = 0
    pred = np.fft.irfft(spec, len(gt)).astype(np.float32)
    return pred, gt


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (512, 128)])
def test_stft_and_mel_equal_jax(signals, n_fft, hop):
    pred, _ = signals
    close(tm.stft_magnitude(pred, n_fft, hop), jm.stft_magnitude(pred, n_fft,
                                                                 hop))
    for n_mels, fmin, fmax in ((80, 0.0, None), (40, 50.0, 16000.0)):
        close(tm.mel_filterbank(SR, n_fft, n_mels, fmin, fmax),
              jm.mel_filterbank(SR, n_fft, n_mels, fmin, fmax))
    S = tm.melspectrogram(pred, SR, n_fft, hop, 64)
    close(S, jm.melspectrogram(pred, SR, n_fft, hop, 64))
    close(tm.power_to_db(S), jm.power_to_db(S))
    close(tm.power_to_db(S, amin=1e-6, top_db=40.0),
          jm.power_to_db(S, amin=1e-6, top_db=40.0))


def test_losses_and_grade_equal_jax(signals):
    pred, gt = signals
    lsd, frames = tm.calculate_lsd(pred, gt[:-100])  # lengths differ: cut
    want, want_frames = jm.calculate_lsd(pred, gt[:-100])
    close(lsd, want)
    close(frames, want_frames)
    assert lsd > 0
    got = tm.calculate_mel_loss(pred, gt, sr=SR)
    for g, w in zip(got, jm.calculate_mel_loss(pred, gt, sr=SR)):
        close(g, w)
    l1, l2, per = tm.calculate_multi_scale_mel_loss(pred, gt, sr=SR)
    wl1, wl2, wper = jm.calculate_multi_scale_mel_loss(pred, gt, sr=SR)
    close(l1, wl1)
    close(l2, wl2)
    assert per.keys() == wper.keys()
    for k in per:
        close([per[k]["l1"], per[k]["l2"]], [wper[k]["l1"], wper[k]["l2"]])
    for lsd_db in (0.5, 1.2, 2.0, 3.0):
        for mel in (0.5, 1.5, 3.0, 5.0):
            assert tm.grade_quality(lsd_db, mel) == jm.grade_quality(lsd_db,
                                                                     mel)
    assert sorted(tm.__all__) == sorted(jm.__all__)


def test_layout_equals_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(tlayout.bct_to_btc(x), jlayout.bct_to_btc(x))
    np.testing.assert_array_equal(tlayout.btc_to_bct(x), jlayout.btc_to_bct(x))
    import torch

    t = torch.from_numpy(x)
    assert tlayout.bct_to_btc(t).shape == (2, 4, 3)
    assert torch.equal(tlayout.btc_to_bct(tlayout.bct_to_btc(t)), t)


def test_plots_write_pngs(signals, tmp_path):
    pred, gt = signals
    p1 = plots.plot_audio_spectrum(gt, SR, tmp_path / "a" / "spec.png",
                                   title="gt")
    p2 = plots.plot_comparison([("pred", pred), ("gt", gt)], SR,
                               tmp_path / "cmp.png")
    for p in (p1, p2):
        assert p.exists() and p.stat().st_size > 1000
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_raise_on_call(monkeypatch):
    """The module imports without matplotlib; a call names it."""
    import importlib

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    mod = importlib.reload(plots)
    with pytest.raises(ImportError, match="matplotlib"):
        mod.plot_audio_spectrum(np.zeros(4096), SR, "never.png")
    with pytest.raises(ImportError, match="matplotlib"):
        mod.plot_comparison([("a", np.zeros(4096))], SR, "never.png")
