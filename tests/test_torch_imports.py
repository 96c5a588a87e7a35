"""The port stands alone: it imports neither JAX nor the JAX package, its
config presets equal the JAX package's, and without CUDA its entry points
refuse to run unless asked for the CPU."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "jatsr_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jatsr_tpu', 'flax'))]\n"
            "assert not bad, bad\n"
            "print(len(" + repr(_port_modules()) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_audio_modules_are_among_those_imported():
    """The audio-in, audio-out modules: the codec's converter, resampling,
    stats, WAV I/O, the DiT checkpoint converter and the CLI."""
    assert {"jatsr_torch.models.dac.convert", "jatsr_torch.ops.resample",
            "jatsr_torch.data", "jatsr_torch.data.dataset",
            "jatsr_torch.utils.audio_io", "jatsr_torch.models.convert_dit",
            "jatsr_torch.cli", "jatsr_torch.cli.infer"} <= set(
        _port_modules())


def test_training_modules_are_among_those_imported():
    """The training entry point: the loop, checkpoints, the datasets and
    the native loader's binding, profiling and the CLI."""
    assert {"jatsr_torch.train.loop", "jatsr_torch.train.checkpoint",
            "jatsr_torch.data.native_loader", "jatsr_torch.utils.profiling",
            "jatsr_torch.cli.train"} <= set(_port_modules())


def test_data_and_quality_modules_are_among_those_imported():
    """Data in, quality out: preprocessing, the metrics and plots, the
    layout helpers and the CLIs of that slice."""
    assert {"jatsr_torch.data.preprocess", "jatsr_torch.metrics",
            "jatsr_torch.metrics.audio", "jatsr_torch.metrics.plots",
            "jatsr_torch.utils.layout", "jatsr_torch.cli.prepare_dataset",
            "jatsr_torch.cli.evaluate", "jatsr_torch.cli.plot_spectrum",
            "jatsr_torch.cli.params", "jatsr_torch.cli.check_env"} <= set(
        _port_modules())


def test_parallel_modules_are_among_those_imported():
    """Data-parallel training and serving: the mesh and the process
    group."""
    assert {"jatsr_torch.parallel", "jatsr_torch.parallel.mesh",
            "jatsr_torch.parallel.distributed"} <= set(_port_modules())


def test_tensor_parallel_modules_import_no_jax():
    """Tensor-parallel serving: the kernels' split entries
    (``ops/split.py``) and the model group (``ModelGroup``); imported
    alone, they bring in neither JAX nor the JAX package."""
    assert "jatsr_torch.ops.split" in set(_port_modules())
    code = ("import sys\n"
            "from jatsr_torch.ops import split\n"
            "from jatsr_torch.parallel import ModelGroup, local_params\n"
            "assert all(hasattr(ModelGroup, k) for k in "
            "('max_', 'sum_', 'gather_cols'))\n"
            "assert callable(split.int8_matmul_fused_split)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jatsr_tpu', 'flax'))]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_never_name_the_jax_package():
    files = list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu")) + [
        ROOT / "chip_smoke.py"]
    for f in files:
        assert "jatsr_tpu" not in f.read_text(), f


def test_presets_equal_the_jax_presets():
    from jatsr_tpu.configs import config as jax_config
    from jatsr_torch.configs import config

    assert config.list_presets() == jax_config.list_presets()
    for name in config.list_presets():
        assert dataclasses.asdict(config.get_preset(name)) == \
            dataclasses.asdict(jax_config.get_preset(name)), name
    assert dataclasses.asdict(config.SamplerConfig()) == \
        dataclasses.asdict(jax_config.SamplerConfig())


def _tiny_static():
    from torch_parity import narrow_cfg
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    cfg = narrow_cfg(get_preset)
    return cfg, quantize_params_static(random_dense_params(cfg), cfg)


def _entry_points():
    from jatsr_torch.configs import SamplerConfig, TrainConfig
    from jatsr_torch.infer import InferencePipeline
    from jatsr_torch.models.dac import DAC, DACConfig
    from jatsr_torch.models.dac.model import init_decoder_params, init_params
    from jatsr_torch.models.dit import DiT
    from jatsr_torch.sampling import FlowSampler
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.parallel import make_mesh
    from jatsr_torch.train import create_train_state
    from jatsr_torch.train.step import Normalizer
    from jatsr_torch.cli import prepare_dataset as prepare_cli
    from jatsr_torch.cli import train as train_cli
    from jatsr_torch.configs import get_preset
    from jatsr_torch.train.loop import Trainer

    small = DACConfig(encoder_dim=256, encoder_rates=(2, 4), decoder_dim=16,
                      decoder_rates=(4, 2))
    ones = np.ones(4, np.float32)
    return {
        "DiT": lambda: DiT(*_tiny_static()),
        "DAC": lambda: DAC(init_decoder_params(small), small),
        "DAC.random_init": lambda: DAC.random_init(0, small),
        "DAC whole codec": lambda: DAC(init_params(small), small),
        "DAC bf16 decode": lambda: DAC(init_params(small), small,
                                       compute_dtype=torch.bfloat16),
        "Normalizer": lambda: Normalizer(ones, ones, ones, ones),
        "FlowSampler": lambda: FlowSampler(lambda *a: None, SamplerConfig()),
        "InferencePipeline": lambda: InferencePipeline(None, None),
        "DenseDiT": lambda: DenseDiT(_tiny_train_cfg()),
        "create_train_state": lambda: create_train_state(
            DenseDiT(_tiny_train_cfg(), device="cpu"), TrainConfig(), 10,
            (np.zeros((1, 8, 1024)),) * 2),
        "Trainer": lambda: Trainer(get_preset("tiny"), data_dir="absent"),
        "train CLI": lambda: train_cli.main(["--preset", "tiny",
                                             "--data-dir", "absent"]),
        "prepare_dataset CLI": lambda: prepare_cli.main(
            ["--source-dirs", "absent", "--output-dir", "absent"]),
        "make_mesh": lambda: make_mesh(1, 1),
    }


def _tiny_train_cfg():
    from jatsr_torch.configs import get_preset

    return get_preset("tiny").model


@pytest.mark.parametrize("name", ["DiT", "DAC", "DAC.random_init",
                                  "DAC whole codec", "DAC bf16 decode",
                                  "Normalizer", "FlowSampler",
                                  "InferencePipeline", "DenseDiT",
                                  "create_train_state", "Trainer",
                                  "train CLI", "prepare_dataset CLI",
                                  "make_mesh"])
def test_entry_points_refuse_to_run_on_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_kernel_wrappers_run_the_plain_version_only_on_cpu_tensors():
    """A CPU tensor takes the plain version and counts no launch."""
    from jatsr_torch.ops.attention import gqa_attention_flash_qkv
    from jatsr_torch.ops.attention_train import (attention_train_bwd,
                                                 attention_train_fwd)
    from jatsr_torch.ops.int8_matmul import int8_dense_gelu_quant

    n0 = (gqa_attention_flash_qkv.launches, int8_dense_gelu_quant.launches,
          attention_train_fwd.launches, attention_train_bwd.launches)
    qkv = torch.zeros(1, 8, 6 * 64, dtype=torch.bfloat16)
    cs = torch.ones(8, 64)
    gqa_attention_flash_qkv(qkv, cs, cs, 2, 2)
    int8_dense_gelu_quant(torch.ones(20, 64, dtype=torch.bfloat16),
                          torch.ones(64, 128, dtype=torch.int8),
                          torch.ones(1, 128), torch.zeros(1, 128))
    q = torch.ones(1, 8, 2 * 64, dtype=torch.bfloat16)
    o, _ = attention_train_fwd(q, q, q, 1, 2, 2, 0.1)
    attention_train_bwd(q, q, q, o, q, 1, 2, 2, 0.1)
    assert (gqa_attention_flash_qkv.launches, int8_dense_gelu_quant.launches,
            attention_train_fwd.launches, attention_train_bwd.launches) == n0
