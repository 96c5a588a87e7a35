"""Tensor-parallel training and serving of ``DenseDiT`` (the ``model`` axis
of ``jatsr_torch/parallel/``) on the CPU.

Two gloo ranks on a (1, 2) mesh and four on a (2, 2) mesh, each world
spawned once for the module (``torch_tp_train_worker``, a file store under
the test's directory, the ``spawn`` start method: this process has
imported JAX); at (1, 2) rank 0 then runs the one-process references with
the same thread count.  The checks read what each rank saved.  Bounds:

- against one process of the port, two steps under the MSE loss (tiny,
  dropout 0.1, drop-path 0.05, B10's plain versions): each step's loss
  and grad norm within rtol 2e-4 (the JAX package's bound on the loss for
  its (4, 2) mesh against one device, ``tests/test_train_step.py``), every
  parameter within 2 lr after the second step (the first runs at lr 0
  under warmup; Adam's step is +-lr where a gradient's sign differs); at
  fp32 compute the loss and the grad norm within rtol 1e-5;
- dynamic int8, on "xla" and on "pallas" (B14): the forward bit-equal to
  one process (every split takes row maxima and adds int32 partial
  products, exact in any order), the gradients within one bf16 ulp of
  each leaf's max; two "pallas" steps within the bf16 steps' bounds;
- ZeRO-1 on (2, 2) bit-equal to the same mesh without it; the replicated
  leaves' gradients equal on the ranks of a model group;
- under each remat policy one forward and backward: the output and the
  gradients within one bf16 ulp of each leaf's max (g sums the ranks'
  fp32 partial products and rounds once, as one card's product rounds;
  f sums the ranks' fp32 partial cotangents and rounds once too);
- against JAX on ``make_mesh(2, 2)`` (the virtual CPU devices of
  ``tests/conftest.py``): the (2, 2) step fed the JAX step's draws within
  the bounds ``tests/test_torch_train_step.py`` holds the one-process
  step to; the bf16 pipeline within atol 1e-3 of the port on one process
  (JAX's bound for its mesh against one device,
  ``tests/test_trainer_and_infer.py``) and within the bound
  ``tests/test_torch_pipeline.py`` holds the port's pipeline to JAX's;
- checkpoints hold whole leaves: a (2, 2) one restores into one process
  bit for bit, a one-process one into a (1, 2) ``Trainer`` bit for bit,
  and a step runs after each;
- ``cli.train --mesh 1 2`` writes whole leaves, and ``cli.infer --mesh 1
  2`` (the bf16 model) on its run writes a wav within 1e-3 of the
  one-process CLI's on the same run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as pw
import torch_tp_train_worker as w
from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_torch.models.dit import DenseDiT
from jatsr_torch.models.from_jax import random_dense_params

SHAPES = [(1, 2), (2, 2)]


def _jax_cfg(**kw):
    return dataclasses.replace(jax_get_preset("tiny").model,
                               input_channels=w.C, cond_channels=w.C, **kw)


def _sharded(mesh, state):
    """A JAX train state placed as the JAX trainer places it on ``mesh``."""
    from jatsr_tpu.parallel import param_shardings, replicated

    rep = replicated(mesh)
    return state.replace(
        params=jax.device_put(state.params, param_shardings(mesh,
                                                            state.params)),
        opt_state=jax.device_put(state.opt_state, jax.tree_util.tree_map(
            lambda _: rep, state.opt_state,
            is_leaf=lambda x: isinstance(x, jax.Array))),
        step=jax.device_put(state.step, rep),
        rng=jax.device_put(state.rng, rep))


def _jax_step_case():
    """Two JAX steps on ``make_mesh(2, 2)`` from the worker's tree and
    batch, its draws rebuilt as ``train/step.py`` makes them: ``(draws,
    metrics, params)``."""
    from jatsr_tpu.configs import LossConfig as JaxLossConfig
    from jatsr_tpu.configs import TrainConfig as JaxTrainConfig
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.parallel import batch_sharding
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.train import make_train_step as jax_train_step
    from jatsr_tpu.train.state import TrainState as JaxTrainState
    from jatsr_tpu.train.state import make_optimizer as jax_make_optimizer
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer
    from jatsr_tpu.utils.runtime import select_prng_impl

    hr, lr, stats = w.step_batch()
    tcfg = JaxTrainConfig(**dataclasses.asdict(w.train_cfg()))
    dense = random_dense_params(w.model_cfg(), 3)
    # The JAX package's create_train_state on the given tree (its
    # model.init skipped), the einsum attention on both sides (off a TPU
    # the JAX model takes it; B10 against JAX:
    # tests/test_torch_attention_train.py).
    select_prng_impl(tcfg.prng_impl)
    _, state_key = jax.random.split(jax.random.PRNGKey(tcfg.seed))
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    tx = jax_make_optimizer(tcfg, 100)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), rng=state_key, tx=tx,
                          apply_fn=JaxDiT(_jax_cfg(**w.JAX_KNOBS)).apply)
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    step = jax.jit(jax_train_step(JaxLossConfig(use_latent_perceptual=False),
                                  tcfg, JaxNormalizer(*stats)))
    bs = batch_sharding(mesh)
    draws, metrics = [], []
    for s in range(2):
        state = _sharded(mesh, state)  # one placement: one compile
        rng = jax.random.fold_in(state.rng, s)
        k_noise, k_t, k_cond, k_cfg, _ = jax.random.split(rng, 5)
        shape = hr.shape
        draws.append({
            "noise": torch.from_numpy(np.array(
                jax.random.normal(k_noise, shape))),
            "u": torch.from_numpy(np.array(
                jax.random.uniform(k_t, (shape[0],)))),
            "cond_noise": torch.from_numpy(np.array(
                jax.random.normal(k_cond, shape))),
            "cfg_u": torch.from_numpy(np.array(
                jax.random.uniform(k_cfg, (shape[0], 1, 1)))),
            "layer_seeds": [0, 0]})
        state, m = step(state, jax.device_put(hr, bs),
                        jax.device_put(lr, bs))
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {k: np.asarray(v, np.float32) for k, v in _jax_named(state.params)}
    start = {k: np.asarray(v, np.float32) for k, v in _jax_named(params)}
    return ({"steps": draws, "dense": jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), dense)},
        metrics, flat, start)


def _jax_named(tree):
    """A JAX-layout tree's leaves by the port's parameter names."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                out.append((".".join(["blocks", str(i)] + keys[1:]),
                            leaf[i]))
        else:
            out.append((".".join(keys), leaf))
    return out


def _jax_pipeline_case(root):
    """JAX's chunk noise for the worker's three chunks, and JAX's bf16
    ``InferencePipeline`` on ``make_mesh(2, 2)`` over the worker's tree."""
    from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
    from jatsr_tpu.infer.pipeline import InferencePipeline as JaxPipeline
    from jatsr_tpu.infer.pipeline import _per_chunk_noise
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer

    jcfg = dataclasses.replace(jax_get_preset("tiny").model,
                               input_channels=w.SERVE_C,
                               cond_channels=w.SERVE_C,
                               attention_impl="flash")
    dense = random_dense_params(w.serve_cfg(), 7)
    torch.save(jax.tree_util.tree_map(torch.from_numpy, dense),
               root / "serve_tree.pt")
    stats, lr = w.serve_inputs()
    key = jax.random.PRNGKey(9)
    pipe = JaxPipeline(JaxDiT(jcfg), jax.tree_util.tree_map(jnp.asarray,
                                                            dense),
                       JaxNormalizer(*stats),
                       sampler_cfg=JaxSamplerConfig(**w.SERVE_KW),
                       mesh=jax_make_mesh(2, 2, devices=jax.devices()[:4]))
    noise = np.asarray(_per_chunk_noise(key, 3, pipe.chunk_frames, w.SERVE_C))
    np.save(root / "noise.npy", noise)
    return pipe.super_resolve_latent(lr, key, cfg_scale=2.0)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("tp_train")
    draws, jm, jparams, start = _jax_step_case()
    torch.save(draws, root / "draws.pt")
    jserve = _jax_pipeline_case(root)
    pw.mini_dataset(root / "fit" / "data")
    pw.run_fit(None, root / "fit", "11110000")
    from jatsr_torch.train import CheckpointManager

    # The (1, 2) trainer resumes this run and writes its own `last` there.
    torch.save(CheckpointManager(root / "fit" / "ckpt" / "tiny" /
                                 "11110000").load("last")["state"],
               root / "fit_last.pt")
    w.cli_files(root)
    outs = {}
    for shape in SHAPES:
        n = shape[0] * shape[1]
        mp.start_processes(w.main, args=(n, str(root), shape), nprocs=n,
                           start_method="spawn")
        tag = f"tp{shape[0]}x{shape[1]}_"
        outs[shape] = [torch.load(root / f"{tag}{r}.pt") for r in range(n)]
    solo = torch.load(root / "solo.pt")
    return root, outs, solo, (jm, jparams, start, jserve)


def _assert_steps(got, want, rtol, lr1=1e-3):
    for g, s in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], s[k], rtol=rtol, err_msg=k)
    for k, v in want["params"].items():
        d = (got["params"][k].float() - v.float()).abs().max().item()
        assert d <= 2 * lr1 * 1.01, (k, d)


@pytest.mark.parametrize("case", list(w.STEP_CASES))
def test_two_steps_on_1x2_equal_one_process(worlds, case):
    _, outs, solo, _ = worlds
    for rank in outs[(1, 2)]:
        _assert_steps(rank[case], solo[case],
                      1e-5 if case == "fp32" else 2e-4)


def test_step_moved_the_parameters(worlds):
    """The second step moves the parameters by about lr, so the bound of
    2 lr checks an update (the first step's lr is 0)."""
    _, outs, solo, _ = worlds
    start = random_dense_params(w.model_cfg(**w.DROP), 3)
    moved = max(float(np.abs(solo["bf16"]["params"]["patch_in.kernel"]
                             .numpy() - start["patch_in"]["kernel"]).max()),
                0.0)
    assert moved > 0.5e-3


def test_zero1_on_2x2_is_bit_equal_and_ranks_agree(worlds):
    _, outs, _, _ = worlds
    ranks = outs[(2, 2)]
    for r in ranks:
        for part in ("params", "mu", "nu"):
            for k, v in r["bf16"][part].items():
                assert torch.equal(r["bf16_zero"][part][k], v), (part, k)
        assert r["bf16"]["metrics"] == ranks[0]["bf16"]["metrics"]


def test_2x2_steps_equal_one_process(worlds):
    """The (2, 2) mesh against the (1, 2) one and one process: data
    parallel rows drawn whole, so within the same bounds."""
    _, outs, solo, _ = worlds
    for r in outs[(2, 2)]:
        _assert_steps(r["bf16"], solo["bf16"], 2e-4)


def _assert_within_ulp(got, want, what):
    """Each leaf of ``got`` within one bf16 ulp of ``want``'s max."""
    for k, v in want.items():
        m = v.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0
        d = (got[k].float() - v.float()).abs().max().item()
        assert d <= ulp, (what, k, d, ulp)


@pytest.mark.parametrize("policy", w.POLICIES)
def test_gradients_under_each_remat_policy(worlds, policy):
    _, outs, solo, _ = worlds
    want = solo[f"grads_{policy}"]
    for r in outs[(1, 2)]:
        got = r[f"grads_{policy}"]
        _assert_within_ulp({"out": got["out"]}, {"out": want["out"]}, policy)
        _assert_within_ulp(got["grads"], want["grads"], policy)


def test_replicated_gradients_equal_across_model_ranks(worlds):
    _, outs, _, _ = worlds
    a, b = outs[(1, 2)]
    for policy in w.POLICIES + ("int8",):
        for k, v in a[f"grads_{policy}"]["replicated"].items():
            assert torch.equal(b[f"grads_{policy}"]["replicated"][k], v), k


def test_dynamic_int8_forward_bit_equal_gradients_within_an_ulp(worlds):
    _, outs, solo, _ = worlds
    want = solo["grads_int8"]
    for r in outs[(1, 2)]:
        got = r["grads_int8"]
        assert torch.equal(got["out"], want["out"])
        _assert_within_ulp(got["grads"], want["grads"], "int8")


def test_dynamic_int8_on_pallas_forward_bit_equal(worlds):
    """Dynamic int8 on ``int8_impl="pallas"`` (B14's split entry at
    out_proj and mlp_out on the card): the forward bit-equal to one
    process, the gradients within one bf16 ulp of each leaf's max, as on
    "xla"; its two steps are a case of
    ``test_two_steps_on_1x2_equal_one_process``."""
    _, outs, solo, _ = worlds
    want = solo["grads_int8_pallas"]
    assert torch.equal(want["out"], solo["grads_int8"]["out"])
    for r in outs[(1, 2)]:
        got = r["grads_int8_pallas"]
        assert torch.equal(got["out"], want["out"])
        _assert_within_ulp(got["grads"], want["grads"], "int8_pallas")


def test_2x2_step_against_jax_make_mesh_2x2(worlds):
    """The port's (2, 2) step fed the JAX step's draws against the JAX step
    on ``make_mesh(2, 2)``: every metric (``grad_norm`` too) rtol 1e-2 but
    ``cond_noise_std`` rtol 1e-6, ``snr_db`` atol 1e-2 and ``pred_mean``
    atol 1e-3, parameters within 2 lr and 2 % of lr on average
    (``tests/test_torch_train_step.py``'s bounds)."""
    _, outs, solo, (jm, jparams, start, _) = worlds
    for r in outs[(2, 2)]:
        for m, j in zip(r["jax"]["metrics"], jm):
            assert set(m) == set(j)
            np.testing.assert_allclose(m["cond_noise_std"],
                                       j["cond_noise_std"], rtol=1e-6)
            for k in set(j) - {"cond_noise_std", "snr_db", "pred_mean"}:
                np.testing.assert_allclose(m[k], j[k], rtol=1e-2, err_msg=k)
            np.testing.assert_allclose(m["snr_db"], j["snr_db"], atol=1e-2)
            np.testing.assert_allclose(m["pred_mean"], j["pred_mean"],
                                       atol=1e-3)
        moved = 0.0
        for k, want in jparams.items():
            d = np.abs(r["jax"]["params"][k].float().numpy() - want)
            assert d.max() <= 2e-3 * 1.01 and d.mean() <= 2e-5, k
            moved = max(moved, float(np.abs(want - start[k]).max()))
        assert moved > 0.5e-3
    _assert_steps(outs[(2, 2)][0]["jax"], solo["jax"], 2e-4)


def test_bf16_pipeline_on_2x2(worlds):
    """Every rank's samples equal; within atol 1e-3 of one process; and
    against JAX's pipeline on ``make_mesh(2, 2)`` within the port's
    one-process bound against JAX (max 5e-2, relative L2 5e-2)."""
    _, outs, solo, (*_, jserve) = worlds
    ranks = outs[(2, 2)]
    for r in ranks + outs[(1, 2)]:
        assert torch.equal(r["serve"], ranks[0]["serve"])
    got = ranks[0]["serve"].numpy()
    np.testing.assert_allclose(got, solo["serve"].numpy(), atol=1e-3)
    want = np.asarray(jserve)
    np.testing.assert_allclose(got, want, atol=5e-2)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-2


def test_a_rank_holds_the_rule_tables_leaves(worlds):
    """``DenseDiT(mesh=)`` on (1, 2): each parameter the JAX rule table
    splits (``param_specs``: q/k/v by heads, mlp_in's and the AdaLN's
    columns, out_proj's and mlp_out's rows) holds half of its split dim,
    the rest whole; its q heads start at ``h0 = rank * Hq / 2``; a rank's
    q_proj is its columns of ``local_params``."""
    from jatsr_torch.parallel import param_specs
    from jatsr_torch.parallel.mesh import MODEL_AXIS

    _, outs, _, _ = worlds
    cfg = w.model_cfg()
    tree = random_dense_params(cfg, 3)
    whole = dict(DenseDiT(cfg, tree, device="cpu").named_parameters())
    specs = param_specs(tree, 1, 2)
    for r, out in enumerate(outs[(1, 2)]):
        p = out["placement"]
        for k, v in whole.items():
            parts = k.split(".")
            path = "/".join(["blocks"] + parts[2:] if parts[0] == "blocks"
                            else parts)
            spec = specs[path][1:] if parts[0] == "blocks" else specs[path]
            want = list(v.shape)
            if MODEL_AXIS in spec:
                dim = spec.index(MODEL_AXIS)
                assert p["split"][k] == dim, k
                want[dim] //= 2
            else:
                assert k not in p["split"], k
            assert list(p["shapes"][k]) == want, k
        assert p["q_heads"] == [2, 2] and p["h0"] == [2 * r, 2 * r]
        assert torch.equal(p["q_param"], p["q_proj"].float())
        assert torch.equal(p["q_param"],
                           whole["blocks.1.attn.q_proj.kernel"]
                           [:, r * 64:(r + 1) * 64].detach())


def test_2x2_checkpoint_resumes_on_one_process(worlds):
    """The (2, 2) run's ``last`` holds whole leaves: restored into one
    process, its state is the mesh's bit for bit, and a step runs."""
    from jatsr_torch.configs import LossConfig
    from jatsr_torch.train import (CheckpointManager, create_train_state,
                                   make_train_step)
    from jatsr_torch.train.step import Normalizer

    root, outs, _, _ = worlds
    cfg = w.model_cfg(**w.DROP)
    hr, lr, stats = w.step_batch()
    state = create_train_state(DenseDiT(cfg, random_dense_params(cfg, 0),
                                        device="cpu"), w.train_cfg(), 100,
                               (hr, lr), device="cpu")
    state, _ = CheckpointManager(root / "ck22").restore("last", state)
    sd = state.state_dict()
    want = outs[(2, 2)][0]["bf16"]
    for part, got in (("params", sd["params"]), ("mu", sd["opt"]["mu"]),
                      ("nu", sd["opt"]["nu"])):
        for k, v in want[part].items():
            assert torch.equal(got[k], v), (part, k)
    assert state.step == 2
    step = make_train_step(LossConfig(use_latent_perceptual=False),
                           w.train_cfg(), Normalizer(*stats, device="cpu"))
    _, m = step(state, torch.from_numpy(hr), torch.from_numpy(lr))
    assert np.isfinite(float(m["loss"]))


def test_one_process_checkpoint_restores_into_a_1x2_trainer(worlds):
    """JAX's ``test_restore_into_sharded_topology``: the one-process run's
    ``last`` into a (1, 2) ``Trainer``, bit for bit, then a step."""
    root, outs, _, _ = worlds
    blob = torch.load(root / "fit_last.pt")
    for r in outs[(1, 2)]:
        got = r["restore"]["restored"]
        for k, v in blob["params"].items():
            assert torch.equal(got[f"p.{k}"], v), k
        for m in ("mu", "nu"):
            for k, v in blob["opt"][m].items():
                assert torch.equal(got[f"{m}.{k}"], v), (m, k)
        after = r["restore"]["after"]
        assert after["step"] == got["step"] + 1
        assert all(torch.isfinite(v).all() for k, v in after.items()
                   if k.startswith("p."))


def test_cli_train_and_infer_on_1x2(worlds):
    """``cli.train --mesh 1 2`` writes whole leaves (the one-process
    model's shapes; a step and its ``last``); ``cli.infer --mesh 1 2`` on
    that run writes the wav ``cli.infer`` writes from it on one process,
    within 1e-3."""
    from jatsr_torch.configs import get_preset
    from jatsr_torch.models.from_jax import init_dense_params
    from jatsr_torch.train import CheckpointManager
    from jatsr_torch.utils.audio_io import load_wav

    root, *_ = worlds
    d = root / "cli"
    got = CheckpointManager(d / "checkpoints" / "tiny" / w.CLI_RUN).load(
        "last")
    assert got["state"]["step"] == 1
    cfg = get_preset("tiny").model
    whole = dict(DenseDiT(cfg, init_dense_params(
        cfg, torch.Generator().manual_seed(0)), device="cpu")
        .named_parameters())
    assert got["state"]["params"].keys() == whole.keys()
    for k, v in whole.items():
        assert got["state"]["params"][k].shape == v.shape, k
        for m in ("mu", "nu"):
            assert got["state"]["opt"][m][k].shape == v.shape, (m, k)
    name = "song.lr_generated_cfg2.0.wav"
    a, sr = load_wav(d / "out_tp" / name)
    b, _ = load_wav(d / "out_solo" / name)
    assert sr == 44100 and a.shape == b.shape and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-3)
