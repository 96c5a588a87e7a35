"""Training at ``dtype="float32"`` and at ``param_dtype="bfloat16"`` against
the JAX package, on the CPU at ``tiny``.

- B10's fp32 mode: the plain forward and the gradients through
  ``gqa_attention_train``'s autograd against JAX's ``gqa_attention_train``
  (Pallas interpret mode) under ``jax.vjp`` on fp32 q/k/v.  Both compute
  every product in fp32, their sums in another order: max abs error <= 1e-5
  x max |JAX| (measured <= 5.5e-7).
- The fp32 backward's launch plan (``_f32_train_plan``, pure Python) for
  every N <= 768 and every head dim <= 256.
- Two whole train steps at fp32, on B10 (JAX in interpret mode,
  ``ALLOW_INTERPRET_DISPATCH`` set as ``tests/test_torch_train_step.py``
  sets it) and on the einsum, fed the JAX step's draws: the metrics rtol
  1e-4 (fp32 sums in another order; measured ~1e-6), the updated
  parameters within 2 lr (a first Adam step moves each parameter by about
  +-lr whatever the gradient's size, so a gradient near zero whose sign
  differs would move it the other way; measured 0.006 lr) and within 1e-4
  lr on average (measured 7e-7 lr).
- Two train steps at bf16 parameters: each parameter leaf bf16, ``mu``
  fp32 and ``nu`` bf16, as JAX's.  The bf16 forward and backward round
  where JAX's do but sum in another order, so the gradients differ as the
  bf16 step tests let them (``tests/test_torch_train_step.py``): the
  moments per leaf normalised by their max within 3e-2 (``mu``, 0.1 g at
  the first step) and 6e-2 (``nu``, g^2; measured 0.009 and 0.014), the
  parameters within 2 lr and 2 % of lr on average (measured 1.95 lr: one
  bf16 ulp at 0.25, and 0.009 lr), at least 75 % of the parameters'
  elements bit-equal to JAX's (measured 86.4 %; 78.1 % in the worst
  leaf), the metrics rtol 1e-2.
- A ``Trainer`` at fp32: two steps, its checkpoints, then ``python -m
  jatsr_torch.cli.infer --run-dir`` on that run, bit-equal to sampling with
  the restored parameters; a bf16-parameter state saved and restored bit
  for bit.

Step parity uses the MSE loss, as ``tests/test_torch_train_step.py``
explains.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_tpu.models import DiT as JaxDiT
from jatsr_tpu.ops import attention_train as jat
from jatsr_tpu.train import create_train_state as jax_create_state
from jatsr_tpu.train import make_train_step as jax_train_step
from jatsr_tpu.train.step import Normalizer as JaxNormalizer
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import (dense_tree_from_module,
                                         random_dense_params)
from jatsr_torch.ops import attention_train as at
from jatsr_torch.train import create_train_state, make_train_step
from jatsr_torch.train.step import Normalizer

from test_torch_cli import _run_pipeline, files  # noqa: F401 (a fixture)
from test_torch_train_step import _jax_draws, _stats

B, T, C = 4, 24, 1024


@pytest.fixture
def jax_flash(monkeypatch):
    monkeypatch.setattr(jat, "ALLOW_INTERPRET_DISPATCH", True)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---- B10's fp32 mode --------------------------------------------------------

@pytest.mark.parametrize("N,hq,hkv,rate", [(40, 4, 2, 0.1), (45, 2, 2, 0.0),
                                           (45, 4, 2, 0.1), (40, 2, 2, 0.0)])
def test_attention_train_fp32_matches_jax(N, hq, hkv, rate):
    """N a multiple of 8 and not, G 2 and 1, dropout 0.1 and 0, D 32."""
    D, seed = 32, -123456789
    rng = np.random.default_rng(N + hq)
    q, k, v, do = (rng.standard_normal((2, N, w * D), dtype=np.float32)
                   for w in (hq, hkv, hkv, hq))
    o_j, vjp = jax.vjp(lambda q, k, v: jat.gqa_attention_train(
        q, k, v, jnp.int32(seed), hq, hkv, rate, interpret=True), q, k, v)
    g_j = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = at.gqa_attention_train(tq, tk, tv, seed, hq, hkv, rate)
    o.backward(torch.from_numpy(do))
    for got, want in ((o.detach(), o_j), *((t.grad, g) for t, g in zip(
            (tq, tk, tv), g_j))):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_fp32_backward_plan_covers_every_n_and_head_dim():
    """For every N <= 768 and D <= 256: the padded head dim is the fp32
    forward's (its sums are the backward's scores), the dk/dv grid takes
    every key once and the dq grid every one of the G N stacked rows once,
    and both launches fit an sm_90 block's shared memory."""
    tiles = {}
    for D in range(1, at.F32_MAX_D + 1):
        DP = next(dp for dp in (32, 64, 128, 256) if D <= dp)
        for G, hkv in ((1, 2), (5, 4)):
            for N in range(1, at.TRAIN_MAX_N + 1):
                p = at._f32_train_plan.__wrapped__(N, G * hkv, hkv, D)
                assert (p.DP, p.G, p.threads) == (DP, G, 256)
                assert p.dkdv_grid == (-(-N // p.T), hkv)
                assert (p.dkdv_grid[0] - 1) * p.T < N <= p.dkdv_grid[0] * p.T
                assert (p.dq_grid[0] - 1) * p.T < G * N <= p.dq_grid[0] * p.T
                assert max(p.dkdv_smem, p.dq_smem) <= 232_448
                tiles[DP] = (p.T, p.dkdv_smem, p.dq_smem)
    # T rows of DP + 1 fp32 for K, V, q and do, the ds (and wd) tiles, and
    # 24 bytes of statistics a row; 64 rows up to DP = 128, 32 at 256.
    for DP, (T, a, b) in tiles.items():
        assert T == (64 if DP <= 128 else 32)
        assert a == 16 * T * (DP + 1) + 8 * T * (T + 1) + 24 * T
        assert b == 16 * T * (DP + 1) + 4 * T * (T + 1) + 24 * T
    for bad in ((0, 4, 2, 32), (769, 4, 2, 32), (40, 4, 2, 257),
                (40, 5, 2, 32)):
        with pytest.raises(ValueError):
            at._f32_train_plan.__wrapped__(*bad)


# ---- whole train steps ------------------------------------------------------

def _steps(knobs, seed, perceptual=False):
    """Two steps of the tiny model under ``knobs`` on both sides (condition
    noise and CFG dropout on, warmup 1 so that the second step moves the
    parameters), fed the JAX step's draws: (JAX state, its metrics, the
    port's state, its metrics) after each step."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig

    from jatsr_torch.configs import LossConfig, TrainConfig

    kw = dict(batch_size=B, lr=1e-3, warmup_steps=1, cfg_dropout_prob=0.5,
              condition_noise_ratio=0.05)
    lkw = dict(use_latent_perceptual=perceptual)
    rng = np.random.default_rng(seed)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    stats = _stats(rng)
    tcfg = dataclasses.replace(get_preset("tiny").model, **knobs)
    dense = random_dense_params(tcfg, seed + 1)
    jmodel = JaxDiT(dataclasses.replace(jax_get_preset("tiny").model,
                                        **knobs))
    jstate = jax_create_state(jmodel, JaxTrainConfig(**kw), total_steps=100,
                              sample_batch=(hr, lr))
    pdt = jnp.dtype(tcfg.param_dtype)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, pdt), dense)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jax.jit(jax_train_step(JaxLossConfig(**lkw), JaxTrainConfig(**kw),
                                   JaxNormalizer(*stats)))
    state = create_train_state(DenseDiT(tcfg, dense, device="cpu"),
                               TrainConfig(**kw), 100, (hr, lr), device="cpu")
    step = make_train_step(LossConfig(**lkw), TrainConfig(**kw),
                           Normalizer(*stats, device="cpu"))
    out = []
    for s in range(2):
        draws = _jax_draws(jstate, s, hr.shape)
        jstate, jm = jstep(jstate, hr, lr)
        state, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                        draws=draws)
        assert set(m) == set(jm)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in m.items()}))
    return jstate, state, out, dense


def _assert_params_within_lr(state, jstate, start, mean=0.02, equal=0.0):
    """Each leaf within 2 lr and within ``mean`` lr on average, and at
    least a share ``equal`` of all elements bit-equal to JAX's."""
    lr1 = 1e-3  # the second step's rate; the first one's is 0 (warmup)
    got, want, start = (
        {k: v.astype(np.float32) for k, v in _flat(t).items()}
        for t in (dense_tree_from_module(state.model), jstate.params, start))
    moved, same, total = 0.0, 0, 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr1 * 1.01, k
        assert d.mean() <= mean * lr1, k
        same, total = same + int((d == 0).sum()), total + d.size
        moved = max(moved, float(np.abs(w - start[k]).max()))
    assert moved > 0.5 * lr1
    assert same >= equal * total


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_fp32_train_steps_match_jax(jax_flash, monkeypatch, attn):
    """dtype="float32": B10's fp32 mode (the plain versions here; JAX's
    kernel in interpret mode) or the einsum attention at fp32; both B10s
    see fp32 q/k/v.  Dropout stays 0 (tiny's): the JAX model draws its
    masks and B10's seeds from its own generator (B10's dropout is held
    above, the masks of the blocks by ``test_remat``'s bit-equalities)."""
    seen = []
    fwd = at.attention_train_fwd

    def spy(q, *a, **k):
        seen.append(q.dtype)
        return fwd(q, *a, **k)

    monkeypatch.setattr(at, "attention_train_fwd", spy)
    jcalls = []
    jfn = jat.gqa_attention_train

    def jspy(q, *a, **k):
        jcalls.append(q.dtype)
        return jfn(q, *a, **k)

    monkeypatch.setattr(jat, "gqa_attention_train", jspy)
    knobs = dict(dtype="float32", train_attention_impl=attn)
    jstate, state, out, dense = _steps(knobs, 60)
    if attn == "flash":
        assert seen and set(seen) == {torch.float32}
        assert jcalls and set(jcalls) == {jnp.dtype("float32")}
    else:
        assert not seen and not jcalls
    for jm, m in out:
        for k in set(jm) - {"cond_noise_std", "snr_db", "pred_mean"}:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(m["cond_noise_std"], jm["cond_noise_std"],
                                   rtol=1e-6)
        np.testing.assert_allclose(m["snr_db"], jm["snr_db"], atol=1e-3)
        np.testing.assert_allclose(m["pred_mean"], jm["pred_mean"],
                                   atol=1e-4)
    assert all(p.dtype == torch.float32 for p in state.params)
    _assert_params_within_lr(state, jstate, dense, mean=1e-4)


def test_bf16_parameter_train_steps_match_jax(jax_flash):
    """param_dtype="bfloat16" (bf16 compute, B10's bf16 mode): the dtypes,
    moments and parameters as the module's docstring bounds them."""
    knobs = dict(param_dtype="bfloat16")
    jstate, state, out, dense = _steps(knobs, 70)
    for jm, m in out:
        for k in set(jm) - {"cond_noise_std", "snr_db", "pred_mean"}:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-2, err_msg=k)
    from jatsr_torch.models.from_jax import dense_tree_from_named

    names = [k for k, _ in state.model.named_parameters()]
    adam = jstate.opt_state[1][0]
    for what, tensors, want, dt, atol in (
            ("params", [p.detach() for p in state.params], jstate.params,
             torch.bfloat16, None),
            ("mu", state.opt_state.mu, adam.mu, torch.float32, 3e-2),
            ("nu", state.opt_state.nu, adam.nu, torch.bfloat16, 6e-2)):
        assert {t.dtype for t in tensors} == {dt}, what
        got = _flat(dense_tree_from_named(dict(zip(names, tensors)),
                                          state.model.cfg))
        for k, w in _flat(want).items():
            assert str(w.dtype) == str(dt).split(".")[1], (what, k)
            if atol is not None:
                w = w.astype(np.float32)
                scale = max(float(np.abs(w).max()), 1e-30)
                np.testing.assert_allclose(got[k] / scale, w / scale,
                                           atol=atol, err_msg=f"{what} {k}")
    _assert_params_within_lr(state, jstate, dense, equal=0.75)
    assert state.step == int(jstate.step) == 2


# ---- the Trainer at fp32, and a bf16 state's checkpoint ---------------------

def test_fp32_trainer_checkpoint_and_serving(files, tmp_path):
    """A ``Trainer`` at dtype="float32" takes two steps (B10's fp32 mode's
    plain versions), writes ``last`` and ``best`` with fp32 state and its
    preset (dtype kept); ``cli.infer --run-dir`` serves the run at fp32,
    bit-equal to sampling with the restored parameters."""
    from jatsr_torch.cli import infer as cli
    from jatsr_torch.configs import Preset
    from jatsr_torch.train import CheckpointManager
    from jatsr_torch.train.loop import Trainer
    from jatsr_torch.utils.audio_io import load_wav, save_wav

    d = files
    data = tmp_path / "data"
    rng = np.random.default_rng(8)
    for split, frames in (("train", (1400, 1400)), ("val", (900,))):
        (data / split).mkdir(parents=True)
        for i, n in enumerate(frames):
            hr = rng.standard_normal((n, C)).astype(np.float16)
            np.save(data / split / f"s{i}.hr.npy", hr)
            np.save(data / split / f"s{i}.lr.npy", (0.5 * hr).astype(
                np.float16))
    (data / "global_stats_separated.json").write_text(
        (d / "stats.json").read_text())
    p = get_preset("tiny")
    preset = dataclasses.replace(
        p, model=dataclasses.replace(p.model, dtype="float32"),
        train=dataclasses.replace(p.train, save_dir_base=str(tmp_path / "ck"),
                                  log_dir_base=str(tmp_path / "runs")))
    n0 = at.attention_train_fwd.launches
    tr = Trainer(preset, data_dir=str(data), run_name="05060708",
                 writer=False, device="cpu")
    tr.fit(max_steps=2, verbose=False)
    assert at.attention_train_fwd.launches == n0  # the CPU: plain versions
    assert tr.state.step == 2
    run = tmp_path / "ck" / "tiny" / "05060708"
    assert Preset.from_json((run / "preset.json").read_text()) == preset
    saved = CheckpointManager(run).load("last")["state"]
    assert {v.dtype for v in saved["params"].values()} == {torch.float32}
    cli.main(["--run-dir", str(run), "--stats", str(d / "stats.json"),
              "--dac-weights", str(d / "dac.pth"), "--input",
              str(d / "song.lr.npy"), "--steps", "2", "--cfg-scale", "2.0",
              "--platform", "cpu", "--output-dir", str(tmp_path / "out")])
    got, _ = load_wav(tmp_path / "out" / "song.lr_generated_cfg2.0.wav")
    save_wav(tmp_path / "want.wav", _run_pipeline(d, run, "best"), 44100)
    want, _ = load_wav(tmp_path / "want.wav")
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, want)


def test_bf16_parameter_state_checkpoints_bit_for_bit(tmp_path):
    """One step at param_dtype="bfloat16", saved and restored into a fresh
    state: parameters and ``nu`` bf16, ``mu`` fp32, all bit-equal; a dtype
    that differs is refused."""
    from jatsr_torch.configs import LossConfig, TrainConfig
    from jatsr_torch.train import CheckpointManager

    cfg = dataclasses.replace(get_preset("tiny").model,
                              param_dtype="bfloat16")
    dense = random_dense_params(cfg, 80)
    rng = np.random.default_rng(81)
    hr, lr = (torch.from_numpy(rng.standard_normal((2, T, C),
                                                   dtype=np.float32))
              for _ in range(2))
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0)

    def fresh():
        return create_train_state(DenseDiT(cfg, dense, device="cpu"), tcfg,
                                  10, (hr, lr), device="cpu")

    state = fresh()
    ones = np.ones(C, np.float32)
    state, _ = make_train_step(LossConfig(), tcfg, Normalizer(
        0 * ones, ones, 0 * ones, ones, device="cpu"))(state, hr, lr)
    ckpt = CheckpointManager(tmp_path / "run")
    ckpt.save("last", state, 0, 1.0)
    back, _ = ckpt.restore("last", fresh())
    a, b = state.state_dict(), back.state_dict()
    for group in ("params",):
        for k, v in a[group].items():
            assert v.dtype == torch.bfloat16 and torch.equal(v, b[group][k])
    for mom, dt in (("mu", torch.float32), ("nu", torch.bfloat16)):
        for k, v in a["opt"][mom].items():
            assert v.dtype == dt and torch.equal(v, b["opt"][mom][k]), k
    assert (back.step, back.opt_state.count) == (1, 1)
    f32 = create_train_state(DenseDiT(get_preset("tiny").model, dense,
                                      device="cpu"), tcfg, 10, (hr, lr),
                             device="cpu")
    with pytest.raises(ValueError, match="cannot replace"):
        f32.load_state_dict(a)
