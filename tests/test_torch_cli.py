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
    ("infer", ["--mesh", "1", "2"]), ("train", ["--mesh", "1", "2"]),
    ("train", ["--distributed", "--mesh", "2", "2"])])
def test_cli_flags_of_later_slices_raise(files, entry, flag):
    """On a model axis past 1 training and the bf16 model are the next
    slice's (the int8 DiT serves there:
    ``tests/test_torch_tensor_parallel.py``)."""
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP section A item 8\(b\)"):
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


def test_cli_train_on_a_mesh_of_one_under_torchrun(run):
    """``torchrun --standalone --nproc_per_node 1`` of ``cli.train
    --distributed --mesh 1 1 --shard-opt-state`` on the CPU (gloo, a world
    of one) writes the run the plain CLI writes (both started together on
    the fixture's data): its ``last`` checkpoint bit-equal, parameters and
    whole moments, and its meta."""
    from jatsr_torch.train import CheckpointManager

    d = run.parents[2]
    args = ["-m", "jatsr_torch.cli.train", "--preset", "tiny", "--platform",
            "cpu", "--data-dir", str(d / "data"), "--max-steps", "2",
            "--native-loader"]
    procs = [subprocess.Popen(
        [sys.executable, *pre, *args, "--run-name", name, *extra],
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
        for pre, name, extra in (
            ((), "01020306", ()),
            (("-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "1"), "01020305",
             ("--distributed", "--mesh", "1", "1", "--shard-opt-state")))]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        assert "[train] done" in stdout
    assert "mesh=[1, 1]" in outs[1][0]
    want = CheckpointManager(run.parent / "01020306").load("last")
    got = CheckpointManager(run.parent / "01020305").load("last")
    assert got["meta"] == want["meta"]
    for k, v in want["state"]["params"].items():
        assert torch.equal(got["state"]["params"][k], v), k
    for m in ("mu", "nu"):
        for k, v in want["state"]["opt"][m].items():
            assert torch.equal(got["state"]["opt"][m][k], v), (m, k)


def test_cli_infer_on_a_mesh_of_one_equals_the_plain_cli(run):
    """``cli.infer --mesh 1 1`` (no launcher: a world of one) writes the
    plain CLI's wav, bit for bit."""
    import torch.distributed as dist

    d = run.parents[2]
    args = ["--run-dir", str(run), "--stats", str(d / "stats.json"),
            "--dac-weights", str(d / "dac.pth"), "--input",
            str(d / "song.lr.npy"), "--steps", "2", "--cfg-scale", "2.0",
            "--platform", "cpu"]
    cli.main([*args, "--output-dir", str(d / "out_plain")])
    try:
        cli.main([*args, "--output-dir", str(d / "out_mesh"), "--mesh", "1",
                  "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    name = "song.lr_generated_cfg2.0.wav"
    got, _ = load_wav(d / "out_mesh" / name)
    want, _ = load_wav(d / "out_plain" / name)
    np.testing.assert_array_equal(got, want)


# ---- data in, quality out --------------------------------------------------

TINY_CODEC = dict(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=16,
                  decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
                  codebook_dim=4)


@pytest.fixture
def tiny_codec(monkeypatch):
    """The CLI's codec at ``test_data_pipeline.py``'s tiny geometry (the
    production encoder on 8 s windows is minutes of CPU): ``DAC`` and
    ``load_torch_checkpoint`` replaced where the CLI imports them; returns
    the checkpoint paths the CLI loaded."""
    from jatsr_torch.models import dac as dac_pkg
    from jatsr_torch.models.dac import convert as dac_convert
    from jatsr_torch.models.dac import init_params

    cfg = DACConfig(**TINY_CODEC)

    class TinyDAC(DAC):
        def __init__(self, params, cfg_=None, **kw):
            super().__init__(params, cfg, **kw)

        @classmethod
        def random_init(cls, seed=0, cfg_=None, **kw):
            return cls(init_params(cfg, seed), **kw)

    loaded = []
    monkeypatch.setattr(dac_pkg, "DAC", TinyDAC)
    monkeypatch.setattr(dac_convert, "load_torch_checkpoint",
                        lambda p: loaded.append(p) or init_params(cfg, 7))
    return TinyDAC, loaded


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two songs at the rates users bring (48 and 44.1 kHz) and one under
    ``min_duration``."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(3)
    for name, sr, secs in (("a", 48000, 1.5), ("b", 44100, 1.2),
                           ("short", 48000, 0.5)):
        t = np.arange(int(sr * secs)) / sr
        save_wav(d / f"{name}.wav", (0.3 * np.sin(2 * np.pi * 330 * t)
                                     + 0.05 * rng.standard_normal(len(t))
                                     ).astype(np.float32), sr)
    return d


@pytest.fixture
def one_cpu_thread():
    """One torch CPU thread for the tiny codec (``tests/
    test_torch_preprocess.py``'s fixture of that name says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_prepare_dataset_equals_the_pipeline_and_resumes(
        corpus, tiny_codec, one_cpu_thread, tmp_path, capsys):
    from jatsr_torch.cli import prepare_dataset as prep
    from jatsr_torch.configs import DataConfig
    from jatsr_torch.data import PreprocessPipeline

    TinyDAC, loaded = tiny_codec
    out = tmp_path / "out"
    args = ["--source-dirs", str(corpus), "--output-dir", str(out),
            "--chunk-duration", "1.0", "--overlap-duration", "0.1",
            "--platform", "cpu"]
    assert prep.main(args) == {"done": 2, "skipped": 1, "error": 0}
    assert "RANDOM codec weights" in capsys.readouterr().out
    want = tmp_path / "want"
    cfg = dataclasses.replace(DataConfig(), chunk_duration=1.0,
                              overlap_duration=0.1)
    PreprocessPipeline(TinyDAC.random_init(0, device="cpu"), cfg,
                       str(want)).run([str(corpus)], verbose=False)
    got_files = sorted(p.relative_to(out) for p in out.rglob("*.npy"))
    assert got_files == sorted(p.relative_to(want)
                               for p in want.rglob("*.npy"))
    for p in got_files:
        np.testing.assert_array_equal(np.load(out / p), np.load(want / p))
    assert (out / "global_stats_separated.json").read_text() == \
        (want / "global_stats_separated.json").read_text()
    # A second run encodes nothing; the weights' flag reaches the loader.
    assert prep.main([*args, "--dac-weights", "w.pth"]) == {
        "done": 0, "skipped": 1, "error": 0}
    assert loaded == ["w.pth"]
    assert prep.encode_devices(1, "cpu") is None
    with pytest.raises(SystemExit, match="encode-devices"):
        prep.encode_devices(2, "cpu")


@pytest.fixture(scope="module")
def graded(tmp_path_factory):
    """A generated, a ground-truth and an LR wav at 44.1 kHz, 0.5 s."""
    d = tmp_path_factory.mktemp("graded")
    rng = np.random.default_rng(4)
    t = np.arange(22050) / 44100
    gt = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(
        2 * np.pi * 12000 * t) + 0.01 * rng.standard_normal(len(t))
    for name, x in (("gt", gt), ("pred", gt + 0.02 * rng.standard_normal(
            len(t))), ("lr", 0.4 * np.sin(2 * np.pi * 440 * t))):
        save_wav(d / f"{name}.wav", x.astype(np.float32), 44100)
    return d


def test_cli_evaluate_prints_the_jax_report(graded, capsys):
    from jatsr_tpu.cli import evaluate as jax_evaluate
    from jatsr_torch.cli import evaluate

    args = ["--pred", str(graded / "pred.wav"), "--gt",
            str(graded / "gt.wav"), "--lr-baseline", str(graded / "lr.wav")]
    jax_evaluate.main(args)
    want = capsys.readouterr().out
    got = evaluate.main([*args, "--platform", "cpu"])
    assert capsys.readouterr().out == want
    assert "improvement over LR baseline" in want and got["lsd"] > 0


def test_cli_plot_spectrum_writes_pngs(graded, tmp_path):
    from jatsr_torch.cli import plot_spectrum

    one = plot_spectrum.main(["--input", str(graded / "gt.wav"), "--output",
                              str(tmp_path / "one.png"), "--n-mels", "64"])
    many = plot_spectrum.main(["--input", str(graded / "gt.wav"),
                               str(graded / "pred.wav"), "--output",
                               str(tmp_path / "many.png")])
    for p in (one, many):
        assert pathlib.Path(p).read_bytes()[:4] == b"\x89PNG"


def test_cli_params_counts_equal_jax(capsys):
    from jatsr_tpu.cli import params as jax_params
    from jatsr_tpu.configs import list_presets as jax_presets
    from jatsr_torch.cli import params
    from jatsr_torch.configs import list_presets

    assert list_presets() == jax_presets()
    for name in list_presets():
        assert params.analytic_counts(get_preset(name).model) == \
            jax_params.analytic_counts(jax_get_preset(name).model), name
    for argv in (["--preset", "v3mod2"], ["--compare", "v2", "v3"], []):
        jax_params.main(argv)
        want = capsys.readouterr().out
        params.main(argv)
        assert capsys.readouterr().out == want


def test_cli_check_env(capsys):
    from jatsr_torch.cli import check_env

    check_env.main(["--platform", "cpu"])
    out = capsys.readouterr().out
    assert "environment OK" in out
    for name in ("torch", "numpy", "scipy", "native latent loader", "nvcc"):
        assert f"] {name}" in out, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            check_env.main([])
        assert e.value.code == 1
        assert "REQUIRED-MISSING] torch CUDA" in capsys.readouterr().out
