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
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_torch.cli import infer as cli
from jatsr_torch.cli import train as train_cli
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


@pytest.mark.parametrize("entry,flag", [
    ("infer", ["--mesh", "2", "1"]), ("train", ["--mesh", "2", "1"]),
    ("train", ["--distributed"])])
def test_cli_flags_of_later_slices_raise(files, entry, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP section A item 8"):
        if entry == "infer":
            cli.main(_args(files, "song.wav", "out_x", *flag))
        else:
            train_cli.main(["--preset", "tiny", "--platform", "cpu", *flag])


def _int8_library_wav(d, **knobs):
    """The wav the library gives for the CLI's files with the int8 DiT as
    the CLI builds it (``--int8`` and ``knobs``: the CLI's defaults, the
    einsum attention, fp32 scores, fused q/k/v), quantized for its
    layout."""
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = get_preset("tiny")
    params = load_reference_checkpoint(d / "model.pt", cfg.model)
    mcfg = dataclasses.replace(
        cfg.model, scores_dtype="float32", attention_impl="xla",
        matmul_precision="int8_static", fused_qkv=True, dropout=0.0,
        drop_path_rate=0.0, **knobs)
    model = DiT(mcfg, quantize_params_static(params, mcfg), device="cpu")
    codec = DAC(load_torch_checkpoint(d / "dac.pth"), DACConfig(),
                fused_res_units=True, device="cpu")
    pipe = InferencePipeline(
        model, Normalizer(*load_stats(d / "stats.json"), device="cpu"),
        codec, dataclasses.replace(cfg.sampler, num_steps=2, cfg_scale=2.0),
        device="cpu")
    audio, sr = load_wav(d / "song.wav", mono=True)
    return pipe.super_resolve_audio(audio, sr, 0, 2, 2.0)


def test_cli_model_branches_the_port_lacks_raise(files):
    """``--int8 --quantize-head`` at ``tiny``, the branches the port once
    lacked (the int8 head, the unfused QuantDense MLP, and the unfused
    patch embed of tiny's bottleneck 64), now serves: its wav equals the
    library's, bit for bit."""
    cli.main(_args(files, "song.wav", "out_head", "--int8",
                   "--quantize-head"))
    got, _ = load_wav(files / "out_head" / "song_generated_cfg2.0.wav")
    want = _int8_library_wav(files, quantize_head=True, fused_mlp=False)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and np.abs(got).max() <= 1.0


@pytest.mark.parametrize("flags,knobs", [
    ([], dict(fused_mlp=False)),
    (["--fused-mlp"], dict(fused_mlp=True)),
], ids=["int8", "int8_fused_mlp"])
def test_cli_int8_serves_at_tiny(files, flags, knobs):
    """``--int8`` alone (the unfused QuantDense MLP) and with
    ``--fused-mlp`` (B5's MLP; the patch embed stays unfused at tiny's
    bottleneck 64) serve on the CPU and equal the library, bit for bit."""
    out = "out_" + "_".join(["int8", *(f.strip("-") for f in flags)])
    cli.main(_args(files, "song.wav", out, "--int8", *flags))
    got, _ = load_wav(files / out / "song_generated_cfg2.0.wav")
    np.testing.assert_array_equal(got, _int8_library_wav(files, **knobs))


# ---- training, and serving a run ------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(files):
    """``python -m jatsr_torch.cli.train --preset tiny --platform cpu`` on
    seeded latents (1024 channels; 16 s crops of two 1400-frame songs, one
    of 900 frames for validation), stopped after 2 of its 6 steps an epoch
    (``last`` at epoch 0, then ``best``)."""
    d = files
    rng = np.random.default_rng(5)
    for split, frames in (("train", (1400, 1400)), ("val", (900,))):
        (d / "data" / split).mkdir(parents=True)
        for i, n in enumerate(frames):
            hr = rng.standard_normal((n, 1024)).astype(np.float16)
            np.save(d / "data" / split / f"s{i}.hr.npy", hr)
            np.save(d / "data" / split / f"s{i}.lr.npy", (0.5 * hr).astype(
                np.float16))
    (d / "data" / "global_stats_separated.json").write_text(
        (d / "stats.json").read_text())
    out = subprocess.run(
        [sys.executable, "-m", "jatsr_torch.cli.train", "--preset", "tiny",
         "--platform", "cpu", "--data-dir", str(d / "data"), "--max-steps",
         "2", "--run-name", "01020304", "--native-loader"],
        cwd=d, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] done" in out.stdout
    return d / "checkpoints" / "tiny" / "01020304"


def test_cli_train_writes_a_run_in_the_jax_layout(run):
    names = {p.name for p in run.iterdir()}
    assert {"last", "best", "last.meta.json", "best.meta.json",
            "preset.json"} <= names
    meta = json.loads((run / "last.meta.json").read_text())
    assert (meta["epoch"], meta["global_step"], meta["preset"]) == \
        (0, 2, "tiny")
    from jatsr_torch.configs import Preset

    assert Preset.from_json((run / "preset.json").read_text()) == \
        get_preset("tiny")


def test_cli_train_resumes_the_run(run, monkeypatch):
    """``--resume RUN_DIR`` restores `last` (bit-equal to the file) and
    trains the next epoch."""
    from jatsr_torch.train import CheckpointManager
    from jatsr_torch.train.loop import Trainer

    restored = {}
    fit = Trainer.fit

    def spy(self, *a, **k):
        restored.update({k: v.clone() for k, v in
                         self.state.state_dict()["params"].items()})
        restored.update({"count": self.state.opt_state.count,
                         "step": self.state.step})
        return fit(self, *a, **k)

    monkeypatch.setattr(Trainer, "fit", spy)
    monkeypatch.chdir(run.parents[2])
    saved = CheckpointManager(run).load("last")["state"]
    tr = train_cli.main(["--preset", "tiny", "--platform", "cpu",
                         "--data-dir", str(run.parents[2] / "data"),
                         "--resume", str(run), "--epochs", "2"])
    assert (restored["step"], restored["count"]) == (2, 2)
    for k, v in saved["params"].items():
        assert torch.equal(restored[k], v), k
    assert tr.start_epoch == 1 and tr.state.step == 2 + 6
    assert json.loads((run / "last.meta.json").read_text())["epoch"] == 1


def _run_pipeline(d, run, name):
    """What serving ``run``'s checkpoint ``name`` gives for song.lr.npy: the
    CLI's bf16 model (its default flags) on the restored parameters."""
    from jatsr_torch.configs import Preset
    from jatsr_torch.models.from_jax import dense_tree_from_named
    from jatsr_torch.train import CheckpointManager

    preset = Preset.from_json((run / "preset.json").read_text())
    params = dense_tree_from_named(
        CheckpointManager(run).load(name)["state"]["params"], preset.model)
    model = DenseDiT(dataclasses.replace(
        preset.model, attention_impl="xla", dropout=0.0, drop_path_rate=0.0),
        params, device="cpu")
    codec = DAC(load_torch_checkpoint(d / "dac.pth"), DACConfig(),
                fused_res_units=True, device="cpu")
    pipe = InferencePipeline(
        model, Normalizer(*load_stats(d / "stats.json"), device="cpu"),
        codec, dataclasses.replace(preset.sampler, num_steps=2,
                                   cfg_scale=2.0), device="cpu")
    lr = np.load(d / "song.lr.npy").astype(np.float32)
    return pipe.decode_latent(pipe.super_resolve_latent(lr, 0, 2, 2.0))


def test_cli_infer_serves_a_run(run, capsys):
    """``--run-dir`` (``best`` by default, the preset from its
    ``preset.json``) gives, bit for bit, what sampling with the run's
    restored parameters gives; ``--int8`` quantizes them after the
    restore and serves."""
    d = run.parents[2]
    args = ["--run-dir", str(run), "--stats", str(d / "stats.json"),
            "--dac-weights", str(d / "dac.pth"), "--input",
            str(d / "song.lr.npy"), "--steps", "2", "--cfg-scale", "2.0",
            "--platform", "cpu"]
    cli.main([*args, "--output-dir", str(d / "out_run")])
    printed = capsys.readouterr().out
    assert "preset 'tiny' from" in printed and "restored best @ step" \
        in printed
    got, sr = load_wav(d / "out_run" / "song.lr_generated_cfg2.0.wav")
    save_wav(d / "want.wav", _run_pipeline(d, run, "best"), 44100)
    want, _ = load_wav(d / "want.wav")
    np.testing.assert_array_equal(got, want)
    cli.main([*args, "--output-dir", str(d / "out_run8"), "--int8",
              "--checkpoint", "last"])
    got8, _ = load_wav(d / "out_run8" / "song.lr_generated_cfg2.0.wav")
    assert got8.shape == got.shape and np.isfinite(got8).all()
    assert not np.array_equal(got8, got)
