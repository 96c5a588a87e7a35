"""The port's data-parallel layer (``jatsr_torch/parallel/``) on the CPU.

Two ranks over gloo, spawned once for the module (``torch_parallel_worker``,
a file store under the test's directory, the ``spawn`` start method: this
process has imported JAX), run every multi-process case; the checks below
read what each rank saved:

- the tensor-parallel rule table against the JAX package's
  ``param_shardings`` on its virtual (4, 2) and (8, 1) meshes;
- a 2-rank train step against one process on the global batch, dropout and
  drop-path on, at fp32, with bf16 parameters, and with three micro-batches
  cut unequally over the ranks; ZeRO-1 bit-equal to plain data parallelism;
- a 2-rank ``Trainer.fit`` (ranks bit-equal, one run written by rank 0) and
  its checkpoint moved from one process to two and back;
- 2-rank int8 serving bit-equal to one process; ``decode_devices``;
- B10's plain version with a batch offset.

Bounds for the 2-rank step against one process: the two sum the same fp32
numbers in another order (the gradients' all-reduce, the batch statistics'
all-reduce, the micro-batch pieces' weights), so the losses agree to rtol
2e-4 (the JAX package's bound for its mesh step, ``tests/test_train_step.py``)
and a parameter moves by the same Adam update unless a gradient near 0
changes sign: at most 2 lr a step apart.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from jatsr_torch.parallel import make_mesh, param_specs
from jatsr_torch.parallel.distributed import (card_of, process_batch_slice,
                                              put_global_batch)
from jatsr_torch.parallel.mesh import data_size, opt_state_plan

RANKS = 2
LR = 1e-3  # the cases' learning rate (warmup 0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One process's fit (run 11110000), then the two ranks; then one
    process restores the ranks' run."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("parallel")
    w.mini_dataset(root / "data")
    solo_fit = w.run_fit(None, root, "11110000")
    mp.start_processes(w.main, args=(RANKS, str(root)), nprocs=RANKS,
                       start_method="spawn")
    outs = [torch.load(root / f"out{r}.pt", weights_only=False)
            for r in range(RANKS)]
    solo = torch.load(root / "solo.pt", weights_only=False)
    back = w.run_fit(None, root, None, resume=outs[0]["fit"]["run_dir"])
    return root, outs, solo, solo_fit, back


# ---- (1) the rule table -------------------------------------------------


def _trees():
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.ops.quant import quantize_params_static

    base = get_preset("tiny").model
    dense = random_dense_params(base, 0)
    out = {"dense": dense}
    for name, kw in (("static", {}), ("static_split", {"fused_qkv": False}),
                     ("static_head", {"quantize_head": True})):
        cfg = dataclasses.replace(base, matmul_precision="int8_static", **kw)
        out[name] = quantize_params_static(dense, cfg)
    return out


@pytest.mark.parametrize("shape", [(4, 2), (8, 1)])
def test_rule_table_matches_jax_param_shardings(shape):
    """Every leaf of the dense tree and of three int8_static layouts gets
    the JAX package's partition spec (a width that does not divide by the
    model axis replicated)."""
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.parallel import param_shardings

    mesh = jax_make_mesh(*shape)
    for name, tree in _trees().items():
        want = {
            "/".join(str(getattr(k, "key", k)) for k in kp): tuple(s.spec)
            for kp, s in jax.tree_util.tree_leaves_with_path(
                param_shardings(mesh, tree))}
        got = param_specs(tree, *shape)
        assert got == want, name
        if shape == (4, 2):
            assert any(s for s in got.values()), name  # not all replicated


def test_zero1_plan_splits_leading_dims_that_divide():
    assert opt_state_plan([(8, 3), (6,), (3, 4), (0, 2), ()], 2) == \
        [True, True, False, False, False]
    assert opt_state_plan([(5, 5)], 1) == [True]


# ---- (2) rows and meshes ----------------------------------------------------


def test_process_batch_slice_and_mesh_errors():
    assert process_batch_slice(8, 0, 2) == slice(0, 4)
    assert process_batch_slice(8, 1, 2) == slice(4, 8)
    assert process_batch_slice(12, 2, 3) == slice(8, 12)
    assert process_batch_slice(5) == slice(0, 5)  # no process group: one
    with pytest.raises(ValueError, match="divide"):
        process_batch_slice(10, 0, 4)
    with pytest.raises(ValueError, match="mesh 3x1 != 1 processes"):
        make_mesh(3, 1, device="cpu")
    assert data_size(None) == 1
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    (got,) = put_global_batch(None, rows, global_batch=4, device="cpu")
    assert torch.equal(got, torch.from_numpy(rows))
    with pytest.raises(ValueError, match="global batch 8"):
        put_global_batch(None, rows, global_batch=8, device="cpu")


def test_mesh_over_the_ranks(world):
    _, outs, *_ = world
    assert [o["mesh"] for o in outs] == [(RANKS, 1)] * RANKS


# ---- (3) the data-parallel step ---------------------------------------------


def _assert_ranks_equal(outs, key):
    for part in ("params", "mu", "nu"):
        for k, v in outs[0][key][part].items():
            assert torch.equal(v, outs[1][key][part][k]), (key, part, k)
    assert outs[0][key]["metrics"] == outs[1][key]["metrics"]


@pytest.mark.parametrize("case", list(w.STEP_CASES))
def test_data_parallel_step_matches_one_process(world, case):
    """Two steps on 2 ranks against one process on the global batch, the
    ranks bit-equal.  The model computes in bf16, so a rank's weight
    gradient is its rows' sum rounded to bf16 before the all-reduce adds
    it: gradients one bf16 rounding apart (grad norm within rtol 1e-3), and
    a parameter whose gradient is near 0 may take Adam's +-lr step the
    other way: within 2 lr a step, and 2 % of lr on average (the bound of
    ``tests/test_torch_train_step.py``); bf16 parameters also round each
    update to bf16, so one ulp of the parameter more (0.4 lr at |p| =
    0.1), and 5 % of lr on average.  The losses within rtol 2e-4; the
    prediction's mean (near 0) and the SNR in dB (near 0) within 1e-4 and
    1e-3."""
    _, outs, solo, *_ = world
    _assert_ranks_equal(outs, case)
    got, want = outs[0][case], solo[case]
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert set(gm) == set(wm)
        for k in ("loss", "recon_loss", "cond_noise_std"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=2e-4, err_msg=k)
        for k in ("grad_norm", "pred_std"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(gm["pred_mean"], wm["pred_mean"],
                                   atol=1e-4)
        np.testing.assert_allclose(gm["snr_db"], wm["snr_db"], atol=1e-3)
    for k, v in got["eval"].items():
        np.testing.assert_allclose(v, want["eval"][k], rtol=2e-4, err_msg=k)
    bf16 = case == "bf16"
    for k, p in got["params"].items():
        ref = want["params"][k].float()
        d = (p.float() - ref).abs()
        ulp = ref.abs() * 2.0 ** -8 if bf16 else 0.0
        assert bool((d <= 2 * 2 * LR * 1.01 + ulp).all()), k
        assert d.mean() <= (0.05 if bf16 else 0.02) * LR, k


@pytest.mark.parametrize("case", list(w.STEP_CASES))
def test_zero1_is_bit_equal_to_data_parallel(world, case):
    """ZeRO-1 (moments split over the ranks, spans gathered) gives the
    same parameters, moments and metrics, bit for bit, with half the moment
    elements a rank."""
    _, outs, *_ = world
    _assert_ranks_equal(outs, f"{case}_zero")
    for o in outs:
        plain, zero = o[case], o[f"{case}_zero"]
        for part in ("params", "mu", "nu"):
            for k, v in plain[part].items():
                assert torch.equal(zero[part][k], v), (part, k)
                assert zero[part][k].dtype == v.dtype
        assert zero["metrics"] == plain["metrics"]
        assert zero["local_mu_numel"] < 0.6 * plain["local_mu_numel"]


def test_one_process_step_matches_the_jax_mesh_step():
    """The port's step on one process, fed the JAX step's draws, against the
    JAX step on its (8, 1) mesh (one row a device): tiny at 32 channels,
    dropout 0 as its preset has it (the JAX model draws its own masks), on
    the einsum attention (B10's interpret mode is half a minute of JAX
    compile; its parity is ``tests/test_torch_train_step.py``'s): loss
    rtol 2e-4."""
    import jax.numpy as jnp

    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig
    from jatsr_tpu.configs import get_preset as jax_get_preset
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.parallel import batch_sharding, replicated
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.train import create_train_state as jax_create_state
    from jatsr_tpu.train import make_train_step as jax_train_step
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer
    from jatsr_torch.configs import LossConfig, TrainConfig, get_preset
    from jatsr_torch.models.dit import DenseDiT
    from jatsr_torch.models.from_jax import random_dense_params
    from jatsr_torch.train import (Normalizer, create_train_state,
                                   make_train_step)

    B, T, C = 8, 24, 32
    kw = dict(batch_size=B, lr=1e-3, warmup_steps=1, cfg_dropout_prob=0.5)
    rng = np.random.default_rng(41)
    hr, lr = (rng.standard_normal((B, T, C), dtype=np.float32)
              for _ in range(2))
    ones = np.ones(C, np.float32)
    stats = (0 * ones, ones, 0 * ones, ones)
    knobs = dict(input_channels=C, cond_channels=C,
                 train_attention_impl="xla")
    cfg = dataclasses.replace(get_preset("tiny").model, **knobs)
    dense = random_dense_params(cfg, 3)

    jcfg = dataclasses.replace(jax_get_preset("tiny").model, **knobs)
    jstate = jax_create_state(JaxDiT(jcfg),
                              JaxTrainConfig(**kw), total_steps=100,
                              sample_batch=(hr, lr))
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    rk = jax.random.fold_in(jstate.rng, 0)
    k_noise, k_t, k_cond, k_cfg, _ = jax.random.split(rk, 5)
    draws = {"noise": np.asarray(jax.random.normal(k_noise, hr.shape)),
             "u": np.asarray(jax.random.uniform(k_t, (B,))),
             "cond_noise": np.asarray(jax.random.normal(k_cond, hr.shape)),
             "cfg_u": np.asarray(jax.random.uniform(k_cfg, (B, 1, 1))),
             "layer_seeds": [0, 0]}
    mesh = jax_make_mesh(8, 1)
    rep, bs = replicated(mesh), batch_sharding(mesh)
    jstate = jstate.replace(
        params=jax.device_put(jstate.params, rep),
        opt_state=jax.device_put(jstate.opt_state, jax.tree_util.tree_map(
            lambda _: rep, jstate.opt_state,
            is_leaf=lambda x: isinstance(x, jax.Array))),
        step=jax.device_put(jstate.step, rep),
        rng=jax.device_put(jstate.rng, rep))
    jstep = jax.jit(jax_train_step(jax_get_preset("tiny").loss,
                                   JaxTrainConfig(**kw),
                                   JaxNormalizer(*stats)))
    _, jm = jstep(jstate, jax.device_put(hr, bs), jax.device_put(lr, bs))

    state = create_train_state(DenseDiT(cfg, dense, device="cpu"),
                               TrainConfig(**kw), 100, (hr, lr),
                               device="cpu")
    step = make_train_step(LossConfig(), TrainConfig(**kw),
                           Normalizer(*stats, device="cpu"))
    _, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr),
                draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-4)


# ---- (5) the trainer ----------------------------------------------------


def test_two_rank_fit_and_checkpoints_both_ways(world):
    """One epoch on 2 ranks: both ranks' states bit-equal; rank 0 alone
    wrote the run (each checkpoint and meta once, the interval pruned, no
    temporary left); one process restores it bit for bit; 2 ranks restore
    one process's run bit for bit; the 2-rank fit's parameters within the
    step bounds of one process's (three steps) and its best validation loss
    within rtol 2e-4."""
    from pathlib import Path

    root, outs, _, solo_fit, back = world
    a, b = (o["fit"] for o in outs)
    assert a["run_dir"] == b["run_dir"]
    for k, v in a["state"].items():
        assert (torch.equal(v, b["state"][k]) if torch.is_tensor(v)
                else v == b["state"][k]), k
    assert a["best"] == b["best"]
    run = Path(a["run_dir"])
    assert sorted(p.name for p in run.iterdir()) == sorted([
        "best", "best.meta.json", "interval_2", "interval_2.meta.json",
        "last", "last.meta.json", "preset.json"])
    assert a["state"]["step"] == solo_fit["state"]["step"] == 3
    np.testing.assert_allclose(a["best"], solo_fit["best"], rtol=2e-4)
    for k, v in a["state"].items():
        if k.startswith("p."):
            d = (v - solo_fit["state"][k]).abs()
            assert d.max() <= 2 * 3 * LR * 1.01 and d.mean() <= 0.02 * LR, k
    for restored, saved in ((back, a), *((o["from_solo"], solo_fit)
                                         for o in outs)):
        assert restored["start_epoch"] == 1
        for k, v in saved["state"].items():
            assert (torch.equal(restored["state"][k], v) if torch.is_tensor(v)
                    else restored["state"][k] == v), k
    shutil.rmtree(root / "ckpt", ignore_errors=True)


# ---- (6) serving ----------------------------------------------------------


def test_two_rank_int8_serving_is_bit_equal_to_one_process(world):
    """Five chunks of the int8 DiT with the fused prologue: one group
    (padded to six rows) and groups of two (the tail padded), per-chunk
    and group noise; both ranks hold the gathered result."""
    _, outs, solo, *_ = world
    for k, want in solo["serve"].items():
        assert want.shape == (250, w.SERVE_C) and torch.isfinite(want).all()
        for o in outs:
            assert torch.equal(o["serve"][k], want), k


def test_decode_devices_are_bit_equal_to_the_codec():
    from jatsr_torch.infer import InferencePipeline, split_serve_devices
    from jatsr_torch.models.dac import DAC, DACConfig

    cfg = DACConfig(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=16,
                    decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
                    codebook_dim=4)
    codec = DAC.random_init(0, cfg, device="cpu")
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, cfg.latent_dim)).astype(np.float32))
    pipes = [InferencePipeline.__new__(InferencePipeline) for _ in range(2)]
    for p, devs in zip(pipes, (None, ["cpu", "cpu"])):
        InferencePipeline.__init__(p, lambda *a, **k: None, None, codec,
                                   device="cpu", decode_devices=devs)
    want = pipes[0].decode_latent(z, segment_frames=64, ctx_frames=32)
    got = pipes[1].decode_latent(z, segment_frames=64, ctx_frames=32)
    np.testing.assert_array_equal(got, want)
    assert pipes[1]._decode_rr == 5 and len(pipes[1]._decoders) == 1
    assert split_serve_devices(["a", "b", "c"], 1) == (["a", "b"], ["c"])
    with pytest.raises(ValueError, match="must leave >=1 sampler device"):
        split_serve_devices(["a"], 1)


# ---- (7) B10 with a batch offset -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_b10_plain_with_offset_is_the_matching_rows(dtype):
    """Rows ``b0 ..`` of a batch with the offset ``b0`` draw the full
    call's masks (bit-equal) and give its outputs and gradients: bit-equal
    in bf16; in fp32 within 1e-6 (the CPU's batched fp32 product sums a
    smaller batch in another order; a wrong mask moves outputs by ~0.1)."""
    from jatsr_torch.ops import attention_train as at

    g = torch.Generator().manual_seed(4)
    B, N, hq, hkv, D, rate, seed = 5, 45, 4, 2, 32, 0.2, -9
    q, k, v, do = (torch.randn(B, N, h * D, generator=g).to(dtype)
                   for h in (hq, hkv, hkv, hq))
    tol = dict(rtol=0, atol=0) if dtype == torch.bfloat16 else \
        dict(rtol=1e-6, atol=1e-6)
    keep = at._keep_mask(seed, B, hq, N, rate, "cpu")
    o = at.attention_train_fwd_plain(q, k, v, seed, hq, hkv, rate)
    grads = at.attention_train_bwd_plain(q, k, v, o, do, seed, hq, hkv, rate)
    for b0, n in ((2, 3), (1, 1), (0, 2)):
        sl = slice(b0, b0 + n)
        assert torch.equal(at._keep_mask(seed, n, hq, N, rate, "cpu", b0),
                           keep[sl])
        got = at.attention_train_fwd_plain(q[sl], k[sl], v[sl], seed, hq,
                                           hkv, rate, b0=b0)
        torch.testing.assert_close(got, o[sl], **tol)
        part = at.attention_train_bwd_plain(q[sl], k[sl], v[sl], o[sl],
                                            do[sl], seed, hq, hkv, rate,
                                            b0=b0)
        for a, full in zip(part, grads):
            torch.testing.assert_close(a, full[sl], **tol)
    shifted = at.attention_train_fwd_plain(q[:2], k[:2], v[:2], seed, hq,
                                           hkv, rate, b0=1)
    assert not torch.equal(shifted, o[:2])  # the offset reaches the hash


# ---- (8) what this slice refuses ----------------------------------------------


def test_tensor_parallel_and_a_shared_card_under_nccl_raise():
    """Tensor-parallel training is the next slice's (serving on a model
    axis: ``tests/test_torch_tensor_parallel.py``); a mesh needs its
    processes; NCCL refuses two ranks on one card."""
    from jatsr_torch.parallel.mesh import check_no_model_axis

    with pytest.raises(ValueError, match="mesh 1x2 != 1 processes"):
        make_mesh(1, 2, device="cpu")

    class FakeMesh:
        def size(self, dim):
            return (2, 2)[dim]

    assert data_size(FakeMesh()) == 2
    with pytest.raises(NotImplementedError,
                       match=r"tensor-parallel training .* item 8\(b\)"):
        check_no_model_axis(FakeMesh(), "the train step")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one"):
        card_of(0, 2, 1, "nccl")
    assert card_of(1, 2, 1, "gloo") == 0 and card_of(3, 4, 4, "nccl") == 3
