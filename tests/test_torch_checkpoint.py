"""The port's checkpoints: a save and restore gives back every tensor, the
step, the moments' count and the seed bit for bit; ``find_latest_run`` and
``prune_intervals`` give the JAX package's answers on the same directory
trees; a write that is cut off never stands as a checkpoint."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from jatsr_tpu.train import checkpoint as jckpt
from jatsr_torch.configs import LossConfig, TrainConfig, get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import random_dense_params
from jatsr_torch.train import checkpoint as ckpt
from jatsr_torch.train import create_train_state, make_train_step
from jatsr_torch.train.step import Normalizer

C = 32


def _state(seed, moments="float32", steps=1):
    cfg = dataclasses.replace(get_preset("tiny").model, input_channels=C,
                              cond_channels=C)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, seed=seed,
                       adam_moments_dtype=moments)
    rng = np.random.default_rng(seed)
    hr, lr = (torch.from_numpy(rng.standard_normal((2, 24, C),
                                                   dtype=np.float32))
              for _ in range(2))
    state = create_train_state(
        DenseDiT(cfg, random_dense_params(cfg, seed), device="cpu"), tcfg,
        50, (hr, lr), device="cpu")
    ones = np.ones(C, np.float32)
    step = make_train_step(LossConfig(), tcfg,
                           Normalizer(0 * ones, ones, 0 * ones, ones,
                                      device="cpu"))
    for _ in range(steps):
        state, _ = step(state, hr, lr)
    return state


def _tensors(state):
    sd = state.state_dict()
    return {**{f"p.{k}": v for k, v in sd["params"].items()},
            **{f"mu.{k}": v for k, v in sd["opt"]["mu"].items()},
            **{f"nu.{k}": v for k, v in sd["opt"]["nu"].items()}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_round_trip_is_bit_equal(tmp_path, moments):
    saved = _state(0, moments, steps=2)
    mgr = ckpt.CheckpointManager(tmp_path / "run")
    mgr.save("last", saved, epoch=3, best_val_loss=0.25,
             extra={"preset": "tiny"})
    fresh = _state(1, moments, steps=1)
    want, before = _tensors(saved), _tensors(fresh)
    assert any(not torch.equal(want[k], before[k]) for k in want)
    restored, meta = mgr.restore("last", fresh)
    got = _tensors(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert (restored.step, restored.opt_state.count, restored.seed) == \
        (saved.step, saved.opt_state.count, saved.seed) == (2, 2, 0)
    assert meta == {"epoch": 3, "global_step": 2, "best_val_loss": 0.25,
                    "preset": "tiny"}
    assert json.loads((tmp_path / "run" / "last.meta.json").read_text()) \
        == meta
    (op0, n0, b0, _), (op1, n1, b1, _) = mgr.io
    assert (op0, n0, op1, n1) == ("save", "last", "restore", "last")
    assert b0 == b1 > 0
    # The parameters restored are the model's own: its forward moves too.
    x = torch.ones(1, 8, C)
    with torch.no_grad():
        np.testing.assert_array_equal(
            restored.model(x, torch.zeros(1), x).numpy(),
            saved.model(x, torch.zeros(1), x).numpy())


def test_restore_refuses_another_model(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save("last", _state(0), 0, 1.0)
    other = _state(0, "bfloat16")
    with pytest.raises(ValueError, match="cannot replace"):
        mgr.restore("last", other)
    with pytest.raises(FileNotFoundError):
        mgr.restore("best", other)


def _tree(root, runs):
    """``runs``: {name: has_last}."""
    for name, has_last in runs.items():
        (root / name).mkdir(parents=True)
        if has_last:
            (root / name / "last").mkdir()


@pytest.mark.parametrize("runs", [
    {},
    {"01020304": True, "01020305": False, "12312359": False,
     "0102030": True, "notarun0": True},
    {"01020304": False},
    {"01020304": True, "11112222": True, "09091010": True}],
    ids=["empty", "newest_without_last", "none_resumable", "three"])
def test_find_latest_run_equals_jax(tmp_path, runs):
    _tree(tmp_path / "base", runs)
    got = ckpt.find_latest_run(str(tmp_path / "base"))
    want = jckpt.find_latest_run(str(tmp_path / "base"))
    assert got == want
    assert ckpt.find_latest_run(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("keep", [0, 1, 3, 10])
def test_prune_intervals_equals_jax(tmp_path, keep):
    names = ["interval_5", "interval_40", "interval_100", "interval_7",
             "interval_x", "last", "best"]
    trees = {}
    for side in ("port", "jax"):
        run = tmp_path / side
        for n in names:
            (run / n).mkdir(parents=True)
            (run / f"{n}.meta.json").write_text("{}")
        (run / "interval_9").write_text("a file, not a checkpoint")
        mgr = (ckpt.CheckpointManager(run) if side == "port"
               else jckpt.CheckpointManager(run))
        mgr.prune_intervals(keep)
        trees[side] = sorted(p.name for p in run.iterdir())
    assert trees["port"] == trees["jax"]


def test_an_interrupted_write_is_never_found_as_last(tmp_path, monkeypatch):
    base = tmp_path / "tiny"
    mgr = ckpt.CheckpointManager(base / "01020304")
    state = _state(0)

    def cut_off(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 half a file")
        raise KeyboardInterrupt

    real_save = torch.save
    monkeypatch.setattr(torch, "save", cut_off)
    with pytest.raises(KeyboardInterrupt):
        mgr.save("last", state, 0, 1.0)
    assert not mgr.has("last")
    assert ckpt.find_latest_run(str(base)) is None

    # A complete `last`, then a cut-off overwrite: the complete one stands.
    monkeypatch.setattr(torch, "save", real_save)
    mgr.save("last", state, 0, 1.0)
    want = _tensors(state)
    monkeypatch.setattr(torch, "save", cut_off)
    with pytest.raises(KeyboardInterrupt):
        mgr.save("last", _state(1), 1, 0.5)
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt.find_latest_run(str(base)) == base / "01020304"
    restored, meta = mgr.restore("last", _state(2))
    assert meta["epoch"] == 0
    for k, v in _tensors(restored).items():
        assert torch.equal(v, want[k]), k
    shutil.rmtree(base)
