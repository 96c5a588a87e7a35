"""``python -m jatsr_torch.cli.infer`` on the CPU, at ``tiny``.

The test writes what a user brings: a reference-format DiT checkpoint
(``test_dit_convert.py``'s ``TRefDiT`` at ``tiny``), a DAC ``.pth`` of the
published key names (``dac_mirror``'s production-geometry codec, whose
1024-channel latent is ``tiny``'s), a stats JSON and a 0.2 s 16 kHz wav.
The CLI's wav must be the one the port's own pipeline gives for the same
files, bit for bit; the ``.npy`` branch writes its two wavs.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_torch.cli import infer as cli
from jatsr_torch.configs import get_preset
from jatsr_torch.data import load_stats
from jatsr_torch.infer import InferencePipeline
from jatsr_torch.models.convert_dit import load_reference_checkpoint
from jatsr_torch.models.dac import DAC, DACConfig
from jatsr_torch.models.dac.convert import load_torch_checkpoint
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.train.step import Normalizer
from jatsr_torch.utils.audio_io import load_wav, save_wav

from dac_mirror import TorchDAC, mirror_state_dict
from test_dit_convert import TRefDiT


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    torch.manual_seed(0)
    ref = TRefDiT(jax_get_preset("tiny").model)
    torch.save({"model_state_dict": ref.state_dict()}, d / "model.pt")
    from jatsr_tpu.models.dac import DACConfig as JaxDACConfig

    torch.save({"state_dict": mirror_state_dict(TorchDAC(JaxDACConfig()))},
               d / "dac.pth")
    rng = np.random.default_rng(0)
    C = 1024
    (d / "stats.json").write_text(json.dumps({
        "hr_mean": (0.1 * rng.standard_normal(C)).tolist(),
        "hr_std": rng.uniform(0.5, 1.5, C).tolist(),
        "lr_mean": (0.1 * rng.standard_normal(C)).tolist(),
        "lr_std": rng.uniform(0.5, 1.5, C).tolist()}))
    save_wav(d / "song.wav", (0.3 * np.sin(
        2 * np.pi * 440 * np.arange(3200) / 16000)).astype(np.float32), 16000)
    np.save(d / "song.lr.npy", rng.standard_normal((20, C)).astype(np.float16))
    return d


def _args(d, inp, out, *extra):
    return ["--torch-checkpoint", str(d / "model.pt"), "--preset", "tiny",
            "--stats", str(d / "stats.json"), "--dac-weights",
            str(d / "dac.pth"), "--input", str(d / inp), "--output-dir",
            str(d / out), "--steps", "2", "--cfg-scale", "2.0",
            "--platform", "cpu", *extra]


def test_cli_wav_in_wav_out_equals_the_pipeline(files):
    d = files
    cli.main(_args(d, "song.wav", "out"))
    got, sr = load_wav(d / "out" / "song_generated_cfg2.0.wav")
    assert sr == 44100 and got.shape == (18 * 512,)  # ceil(8820 / 512)

    cfg = get_preset("tiny")
    model = DenseDiT(dataclasses.replace(cfg.model, dropout=0.0,
                                         drop_path_rate=0.0),
                     load_reference_checkpoint(d / "model.pt", cfg.model),
                     device="cpu")
    codec = DAC(load_torch_checkpoint(d / "dac.pth"), DACConfig(),
                fused_res_units=True, device="cpu")
    pipe = InferencePipeline(
        model, Normalizer(*load_stats(d / "stats.json"), device="cpu"),
        codec, dataclasses.replace(cfg.sampler, num_steps=2, cfg_scale=2.0),
        device="cpu")
    audio, sr = load_wav(d / "song.wav", mono=True)
    want = pipe.super_resolve_audio(audio, sr, 0, 2, 2.0)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0


def test_cli_latent_in(files, capsys):
    d = files
    cli.main(_args(d, "song.lr.npy", "out_npy", "--solver", "heun",
                   "--attention", "flash"))
    for name in ("song.lr_generated_cfg2.0.wav", "song.lr_lr_input.wav"):
        wav, sr = load_wav(d / "out_npy" / name)
        assert sr == 44100 and wav.shape == (20 * 512,)
    assert "sampler: heun-2" in capsys.readouterr().out


@pytest.mark.parametrize("flag,match", [
    (["--run-dir", "runs/x"], "ROADMAP section A item 5"),
    (["--mesh", "2", "1"], "ROADMAP section A item 8")])
def test_cli_flags_of_later_slices_raise(files, flag, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(_args(files, "song.wav", "out_x", *flag))


def test_cli_model_branches_the_port_lacks_raise(files):
    """``--int8`` at ``tiny`` selects the unfused patch embed (bottleneck
    64) and ``--quantize-head`` the int8 head: the model's config check
    raises for both."""
    with pytest.raises(NotImplementedError, match="quantize_head"):
        cli.main(_args(files, "song.wav", "out_x", "--int8", "--fused-mlp",
                       "--quantize-head"))
    with pytest.raises(NotImplementedError, match="patch embed"):
        cli.main(_args(files, "song.wav", "out_x", "--int8", "--fused-mlp"))
