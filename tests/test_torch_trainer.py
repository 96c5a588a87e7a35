"""The port's Trainer on the CPU, at ``tiny`` with 32 latent channels (the
fixture of ``tests/test_trainer_and_infer.py``):

- the JAX trainer test's four checks (it trains and writes ``last`` and
  ``best``; ``resume="auto"`` continues; a restore replaces fresh weights;
  ``find_latest_run``);
- exact resume: two epochs straight equal one epoch, a resume and one
  epoch bit for bit; ``KeyboardInterrupt`` leaves ``last`` at the last
  completed epoch;
- its TB tags and their steps equal the JAX Trainer's (a recording writer
  on both), and its per-step learning rate equals optax's schedule after
  the ``fit(num_epochs=)`` swap of the horizon;
- a JAX train state after one epoch, carried across by
  ``train_state_from_jax``, takes one step with the JAX step's draws within
  ``tests/test_torch_train_step.py``'s tolerances.

JAX takes the training attention kernel in Pallas interpret mode here
(``ALLOW_INTERPRET_DISPATCH``, set for its trainer's run), as the port
takes B10's plain versions.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.ops import attention_train as jat
from jatsr_tpu.train import make_train_step as jax_train_step
from jatsr_tpu.train.loop import Trainer as JaxTrainer
from jatsr_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import train_state_from_jax
from jatsr_torch.train import create_train_state, make_train_step
from jatsr_torch.train.checkpoint import CheckpointManager, find_latest_run
from jatsr_torch.train.loop import Trainer

C = 32


def _mini_dataset(root: Path, n_songs=3, frames=120):
    rs = np.random.RandomState(0)
    for split, count in [("train", n_songs), ("val", 2)]:
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            hr = rs.randn(frames, C).astype(np.float16)
            lr = (0.8 * hr + 0.1 * rs.randn(frames, C)).astype(np.float16)
            np.save(d / f"s{i}.hr.npy", hr)
            np.save(d / f"s{i}.lr.npy", lr)
    stats = {"hr_mean": [0.0] * C, "hr_std": [1.0] * C,
             "lr_mean": [0.0] * C, "lr_std": [1.0] * C, "total_frames": 1}
    (root / "global_stats_separated.json").write_text(json.dumps(stats))


def _preset(getter, tmp: Path, **train):
    p = getter("tiny")
    return dataclasses.replace(
        p,
        model=dataclasses.replace(p.model, input_channels=C, cond_channels=C),
        train=dataclasses.replace(
            p.train, batch_size=2, save_dir_base=str(tmp / "ckpt"),
            log_dir_base=str(tmp / "runs"), save_interval_steps=0,
            num_epochs=2, warmup_steps=5, lr=1e-3, log_interval_steps=1,
            **train),
        data=dataclasses.replace(p.data, target_duration=64 * 512 / 44100,
                                 samples_per_epoch_multiplier=2))


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, int(step), float(value)))

    def flush(self):
        pass


def _trainer(tmp, run_name=None, **kw):
    return Trainer(_preset(get_preset, tmp), data_dir=str(tmp / "data"),
                   run_name=run_name, device="cpu", **kw)


def _tensors(state):
    sd = state.state_dict()
    return {**{f"p.{k}": v for k, v in sd["params"].items()},
            **{f"mu.{k}": v for k, v in sd["opt"]["mu"].items()},
            **{f"nu.{k}": v for k, v in sd["opt"]["nu"].items()}}


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    _mini_dataset(tmp / "data")
    rec = Recorder()
    tr = _trainer(tmp, "11112222", writer=rec)
    best = tr.fit(verbose=False)
    return tmp, tr, best, rec


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX Trainer on the same data for one of its two epochs (so its
    horizon swaps from 6 to 3 steps), with a recording writer."""
    tmp = tmp_path_factory.mktemp("jax_trainer")
    _mini_dataset(tmp / "data")
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)
        tr = JaxTrainer(_preset(jax_get_preset, tmp),
                        data_dir=str(tmp / "data"), run_name="11112222",
                        writer=rec)
        tr.fit(num_epochs=1, verbose=False)
    return tmp, tr, rec


def test_trainer_runs_and_checkpoints(trained):
    tmp, tr, best, _ = trained
    run_dir = tmp / "ckpt" / "tiny" / "11112222"
    assert (run_dir / "last").exists() and (run_dir / "best").exists()
    assert np.isfinite(best)
    assert tr.state.step == 2 * len(tr.train_loader) == 6
    meta = json.loads((run_dir / "last.meta.json").read_text())
    # `last` is written before the epoch's validation, as JAX writes it.
    assert meta["best_val_loss"] >= best
    assert meta == {"epoch": 1, "global_step": 6, "preset": "tiny",
                    "best_val_loss": meta["best_val_loss"]}
    assert json.loads((run_dir / "preset.json").read_text())["name"] == "tiny"


def test_auto_resume_continues(trained):
    tmp, tr, _, _ = trained
    p = _preset(get_preset, tmp)
    p3 = dataclasses.replace(p, train=dataclasses.replace(p.train,
                                                          num_epochs=3))
    tr2 = Trainer(p3, data_dir=str(tmp / "data"), resume="auto",
                  writer=False, device="cpu")
    assert tr2.start_epoch == 2
    assert tr2.state.step == tr.state.step
    tr2.fit(verbose=False)
    assert tr2.state.step == 3 * len(tr2.train_loader)


def test_restore_actually_loads_weights(trained):
    """A fresh trainer's weights differ from the checkpoint's; after the
    restore they are the trained ones, and a second restore equals it."""
    tmp, tr, _, _ = trained
    fresh = _trainer(tmp, "99999999", writer=False)
    key = "patch_in.kernel"
    fresh_leaf = dict(fresh.model.named_parameters())[key].detach().clone()
    run_dir = tmp / "ckpt" / "tiny" / "11112222"
    restored, meta = CheckpointManager(run_dir).restore("last", fresh.state)
    got = dict(restored.model.named_parameters())[key].detach().clone()
    assert not torch.allclose(got, fresh_leaf)
    assert restored.step == meta["global_step"] > 0
    again, _ = CheckpointManager(run_dir).restore("last", fresh.state)
    assert torch.equal(dict(again.model.named_parameters())[key], got)


def test_find_latest_run(trained):
    tmp = trained[0]
    latest = find_latest_run(str(tmp / "ckpt" / "tiny"))
    assert latest is not None and latest.name == "11112222"


def test_resume_is_exact(trained):
    """One epoch, a resume from its `last`, one more epoch: bit-equal to
    the two epochs straight, parameters, moments and count."""
    tmp, straight, _, _ = trained
    first = _trainer(tmp, "22223333", writer=False)
    first.fit(verbose=False, max_steps=3)
    assert first.state.step == 3
    second = Trainer(_preset(get_preset, tmp), data_dir=str(tmp / "data"),
                     resume=str(first.ckpt.run_dir), writer=False,
                     device="cpu")
    assert second.start_epoch == 1 and second.state.step == 3
    second.fit(verbose=False)
    _assert_states_equal(second.state, straight.state)


def test_interrupt_saves_last_at_the_completed_epoch(trained):
    """``KeyboardInterrupt`` in the second epoch leaves `last` with the
    state at the interrupt and the first epoch as the last completed one,
    as the JAX Trainer does: a resume starts the second epoch again."""
    tmp = trained[0]

    class Interrupt(Recorder):
        def add_scalar(self, tag, value, step):
            if tag == "Train/loss" and step == 5:
                raise KeyboardInterrupt

    cut = _trainer(tmp, "33334444", writer=Interrupt())
    with pytest.raises(KeyboardInterrupt):
        cut.fit(verbose=False)
    assert cut.state.step == 5
    meta = json.loads((cut.ckpt.run_dir / "last.meta.json").read_text())
    assert (meta["epoch"], meta["global_step"]) == (0, 5)
    resumed = Trainer(_preset(get_preset, tmp), data_dir=str(tmp / "data"),
                      resume=str(cut.ckpt.run_dir), writer=False,
                      device="cpu")
    assert resumed.start_epoch == 1
    _assert_states_equal(resumed.state, cut.state)


def test_tb_tags_equal_jax(trained, jax_trained):
    """The port's tags and steps over its first epoch equal the JAX
    Trainer's."""
    rec = trained[3]
    jrec = jax_trained[2]
    per_epoch = ("Val/", "Train/EpochLoss")
    got = {(t, s) for t, s, _ in rec.scalars
           if (s == 0 if t.startswith(per_epoch) else s <= 3)}
    want = {(t, s) for t, s, _ in jrec.scalars}
    assert got == want
    assert {t for t, _ in want} >= {"Train/loss", "Train/steps_per_sec",
                                    "Train/MFU", "Train/EpochLoss",
                                    "Val/loss", "Val/loss_std"}


def test_learning_rate_equals_optax_after_the_horizon_swap(trained,
                                                          jax_trained):
    tmp = trained[0]
    jtr = jax_trained[1]
    tr = _trainer(tmp, "55556666", writer=False)
    assert tr.total_steps == 6
    tr.fit(num_epochs=1, verbose=False)
    assert tr.total_steps == jtr.total_steps == 3
    tcfg = tr.preset.train
    want = jax_warmup_cosine(tcfg.lr, tcfg.warmup_steps, jtr.total_steps)
    for s in range(8):
        np.testing.assert_allclose(tr.state.tx.schedule(s), float(want(s)),
                                   rtol=1e-6, atol=0)
    # The swapped schedule is the one the steps read: step 3 (count 3) is
    # past the 3-step horizon with warmup 5, so its rate is 3/5 lr.
    assert tr.state.tx.schedule(tr.state.opt_state.count) == \
        np.float32(tcfg.lr) * np.float32(3) / np.float32(5)


def test_jax_state_after_an_epoch_steps_on_in_the_port(jax_trained):
    """``train_state_from_jax`` carries the JAX trainer's state (parameters,
    AdamW count and moments, step) into the port's; one more step on one
    batch with the JAX step's draws agrees with JAX's within the step
    tolerances (metrics rtol 1e-2; parameters within 2 lr, 2 % of lr on
    average)."""
    tmp, jtr, _ = jax_trained
    jstate = jtr.state
    preset = _preset(get_preset, tmp)
    sd = train_state_from_jax(jax.device_get(jstate.params),
                              jax.device_get(jstate.opt_state),
                              jax.device_get(jstate.step))
    assert sd["step"] == sd["opt"]["count"] == 3
    hr, lr = next(iter(jtr.train_loader))
    hr, lr = np.asarray(hr), np.asarray(lr)
    state = create_train_state(DenseDiT(preset.model, device="cpu"),
                               preset.train, jtr.total_steps, (hr, lr),
                               device="cpu")
    state.load_state_dict(sd)
    before = {k: v.clone() for k, v in sd["params"].items()}
    rng = jax.random.fold_in(jstate.rng, jstate.step)
    k_noise, k_t, k_cond, k_cfg, _ = jax.random.split(rng, 5)
    draws = {"noise": np.asarray(jax.random.normal(k_noise, hr.shape)),
             "u": np.asarray(jax.random.uniform(k_t, (hr.shape[0],))),
             "cond_noise": np.asarray(jax.random.normal(k_cond, hr.shape)),
             "layer_seeds": [0] * preset.model.depth}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)
        jstep = jax.jit(jax_train_step(jtr.preset.loss, jtr.preset.train,
                                       jtr.normalizer))
        jnext, jm = jstep(jstate, hr, lr)
    step = make_train_step(preset.loss, preset.train,
                           jtr_normalizer(jtr))
    state, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                    draws=draws)
    assert set(m) == set(jm)
    for k in ("loss", "recon_loss", "grad_norm", "pred_std"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2,
                                   err_msg=k)
    lr_step = float(state.tx.schedule(3))
    want = dict(train_state_from_jax(jax.device_get(jnext.params),
                                     jax.device_get(jnext.opt_state), 4)
                ["params"])
    got = dict(state.model.named_parameters())
    moved = 0.0
    for k, w in want.items():
        d = (got[k].detach() - w).abs()
        assert d.max() <= 2 * lr_step * 1.01, k
        assert d.mean() <= 0.02 * lr_step, k
        moved = max(moved, float((w - before[k]).abs().max()))
    assert moved > 0.5 * lr_step


def jtr_normalizer(jtr):
    from jatsr_torch.train.step import Normalizer

    n = jtr.normalizer
    return Normalizer(*(np.asarray(x).reshape(-1) for x in
                        (n.hr_mean, n.hr_std, n.lr_mean, n.lr_std)),
                      device="cpu")


def test_profiling_trace_and_step_timer(trained, tmp_path):
    """``utils.profiling.trace`` writes a TensorBoard trace of the steps it
    wraps (``cli.train --profile-steps``); ``StepTimer`` averages ticks."""
    from jatsr_torch.utils.profiling import StepTimer, trace

    tr = _trainer(trained[0], "66667777", writer=False)
    with trace(str(tmp_path / "profile")):
        tr.fit(verbose=False, max_steps=1)
    assert tr.state.step == 1
    assert list((tmp_path / "profile").glob("*.json"))
    timer = StepTimer()
    assert timer.steps_per_sec() == 0.0
    timer.tick()
    assert timer.steps_per_sec() > 0
