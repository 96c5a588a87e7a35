"""Tensor-parallel serving of the int8 DiT (the ``model`` axis of
``jatsr_torch/parallel/``) on the CPU.

Two gloo ranks on a (1, 2) mesh and four on a (2, 2) mesh, each world
spawned once for the module (``torch_tp_worker``, a file store under the
test's directory, the ``spawn`` start method: this process has imported
JAX); at (1, 2) rank 0 then runs the one-process references with the same
thread count.  The checks read what each rank saved:

- placement: each rank's leaves are the JAX table's slices
  (``param_specs``), but the fused qkv, whose columns are the rank's q, k
  and v heads; its K-major copies and its AdaLN kernel are 1/M;
- the split plain versions of B1, B5, B4, B14 (row-parallel), B12 and
  B13 (one slab the ranks share, and a slab each) and ``w8a8_dot``'s torch
  ops, joined over the ranks, bit-equal to the one-process functions;
- the DiT forward on a given AdaLN table, on every serving branch the
  worker's ``PATHS`` list, bit-equal to one process on both meshes: every
  split adds int32 partial products or takes row maxima, exact in any
  order, and each head and column is computed alone;
- the flash gate at the whole model's heads: at 984 patches tiny's 4/2
  heads fail it and a rank's 2/1 would pass it; both ranks take the split
  q/k/v as one process does, bit-equal;
- the third path's forward on (2, 2) against JAX's ``DiT.apply`` with its
  parameters placed by ``param_shardings`` on ``make_mesh(2, 2)`` (the
  Pallas kernels in interpret mode), within JAX's bounds for its mesh;
- the sampler on (2, 2) bit-equal to one process, and against JAX's
  ``InferencePipeline`` on its own ``make_mesh(2, 2)`` (virtual CPU
  devices) within relative L2 5e-2 (JAX's bound for its mesh,
  ``tests/test_trainer_and_infer.py``) and the max of the port's pipeline
  against JAX's (``tests/test_torch_pipeline.py``, 6e-2);
- what the slice refuses: a model axis that does not divide the kv heads,
  the fp32 compute dtype on each branch, a rank's share off a card
  kernel's tiling, dynamic int8 at fp32;
- ``cli.infer --mesh 1 2`` on a ``.npy`` latent, on bench.py's default
  path and with the CLI's own int8 defaults: the one-process CLI's wav
  bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as w
from jatsr_tpu.configs import get_preset as jax_get_preset
from jatsr_torch.configs import get_preset
from jatsr_torch.models.dit import check_tensor_parallel
from jatsr_torch.parallel import param_specs
from jatsr_torch.parallel.mesh import MODEL_AXIS

SHAPES = [(1, 2), (2, 2)]


def _jax_cfg(**knobs):
    return dataclasses.replace(jax_get_preset("tiny").model, **{
        **dict(bottleneck_dim=128, input_channels=w.C, cond_channels=w.C,
               norm="rms", matmul_precision="int8_static",
               attention_impl="flash", fused_qkv=True, fused_mlp=True),
        **knobs})


def _jax_pipeline_case():
    """JAX's chunk noise for the worker's three chunks, and JAX's
    ``InferencePipeline`` on a (2, 2) mesh of four virtual devices."""
    from jatsr_tpu.configs import SamplerConfig as JaxSamplerConfig
    from jatsr_tpu.infer.pipeline import InferencePipeline as JaxPipeline
    from jatsr_tpu.infer.pipeline import _per_chunk_noise
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.ops.quant import quantize_params_static as jax_quantize
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.train.step import Normalizer as JaxNormalizer
    from jatsr_torch.models.from_jax import random_dense_params

    jcfg = _jax_cfg(**w.PATHS["prologue"])
    jmodel = JaxDiT(jcfg)
    x = jnp.zeros((1, 8, w.C), jnp.float32)
    shape = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, x, jnp.zeros((1,)), x)["params"])
    dense = random_dense_params(w.serve_cfg(**w.PATHS["prologue"]), 7)
    jparams = jax_quantize(jax.tree_util.tree_map(jnp.asarray, dense), shape)
    stats, lr = w.serve_inputs()
    key = jax.random.PRNGKey(9)
    pipe = JaxPipeline(jmodel, jparams, JaxNormalizer(*stats),
                       sampler_cfg=JaxSamplerConfig(**w.SERVE_KW),
                       mesh=jax_make_mesh(2, 2, devices=jax.devices()[:4]))
    frames = pipe.chunk_frames
    noise = np.asarray(_per_chunk_noise(key, 3, frames, w.C))
    return noise, pipe.super_resolve_latent(lr, key, cfg_scale=2.0)


def _cli_files(d):
    """A reference-format tiny DiT checkpoint, the production codec's
    ``.pth``, stats and a 40-frame ``.npy`` latent (the CLI's inputs)."""
    from dac_mirror import TorchDAC, mirror_state_dict
    from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
    from test_dit_convert import TRefDiT

    torch.manual_seed(0)
    ref = TRefDiT(jax_get_preset("tiny").model)
    torch.save({"model_state_dict": ref.state_dict()}, d / "model.pt")
    torch.save({"state_dict": mirror_state_dict(TorchDAC(JaxDACConfig()))},
               d / "dac.pth")
    rng = np.random.default_rng(0)
    C = 1024
    (d / "stats.json").write_text(json.dumps({
        "hr_mean": (0.1 * rng.standard_normal(C)).tolist(),
        "hr_std": rng.uniform(0.5, 1.5, C).tolist(),
        "lr_mean": (0.1 * rng.standard_normal(C)).tolist(),
        "lr_std": rng.uniform(0.5, 1.5, C).tolist()}))
    np.save(d / "song.lr.npy",
            rng.standard_normal((40, C)).astype(np.float16))


def _jax_third_path():
    """JAX's ``DiT.apply`` on the third path at tiny, on the worker's
    forward inputs (computing its own AdaLN rows), with its parameters
    placed by ``param_shardings`` on a (2, 2) mesh of four virtual
    devices."""
    from jatsr_tpu.models import DiT as JaxDiT
    from jatsr_tpu.ops.quant import quantize_params_static as jax_quantize
    from jatsr_tpu.parallel import make_mesh as jax_make_mesh
    from jatsr_tpu.parallel import param_shardings
    from jatsr_torch.models.from_jax import random_dense_params

    jcfg = _jax_cfg(**w.PATHS["opt_in"])
    jmodel = JaxDiT(jcfg)
    x = jnp.zeros((1, 8, w.C), jnp.float32)
    shape = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, x, jnp.zeros((1,)), x)["params"])
    dense = random_dense_params(w.serve_cfg(**w.PATHS["opt_in"]), 7)
    jparams = jax_quantize(jax.tree_util.tree_map(jnp.asarray, dense), shape)
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    placed = jax.device_put(jparams, param_shardings(mesh, jparams))
    x_t, t, x_c, _ = w.forward_inputs()
    fwd = jax.jit(lambda p, a, b, c: jmodel.apply({"params": p}, a, b, c))
    return np.asarray(fwd(placed, *(jnp.asarray(v.numpy())
                                    for v in (x_t, t, x_c))))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("tensor_parallel")
    noise, want = _jax_pipeline_case()
    third = _jax_third_path()
    np.save(root / "noise.npy", noise)
    _cli_files(root)
    outs = {}
    for shape in SHAPES:
        n = shape[0] * shape[1]
        mp.start_processes(w.main, args=(n, str(root), shape), nprocs=n,
                           start_method="spawn")
        outs[shape] = [torch.load(root / f"tp{shape[0]}x{shape[1]}_{r}.pt",
                                  weights_only=False) for r in range(n)]
    solo = torch.load(root / "solo.pt", weights_only=False)
    return root, outs, solo, {"serve": want, "third": third}


# ---- placement ----------------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_placement_follows_the_rule_table(worlds):
    _, outs, _, _ = worlds
    cfg = w.serve_cfg(**w.PATHS["prologue"])
    tree = w.static_tree(cfg)
    specs = param_specs(tree, 1, 2)
    hq, hkv, D, H = 4, 2, cfg.head_dim, cfg.hidden_size
    for r, out in enumerate(outs[(1, 2)]):
        assert out["model_rank"] == r
        local = dict(_leaves(out["placement"]["local"]))
        split = 0
        for path, leaf in _leaves(tree):
            got, spec = np.asarray(local[path]), specs[path]
            if "/qkv_proj/" in path:   # q heads, k head, v head of group r
                heads = [*range(2 * r, 2 * r + 2), hq + r, hq + hkv + r]
                cols = np.concatenate([np.arange(h * D, (h + 1) * D)
                                       for h in heads])
                want = np.take(leaf, cols, axis=-1)
            elif MODEL_AXIS in spec:
                dim = spec.index(MODEL_AXIS)
                n = leaf.shape[dim] // 2
                want = np.take(leaf, np.arange(r * n, (r + 1) * n), axis=dim)
            else:
                want = leaf
            split += MODEL_AXIS in spec
            np.testing.assert_array_equal(got, want, err_msg=path)
        # qkv (codes, scales: no bias), out_proj's codes, mlp_in (3),
        # mlp_out's codes, adaln (2).
        assert split == 9
        mlp = int(H * cfg.mlp_ratio)
        assert out["placement"]["kmajor"] == {
            "qkv": ((hq + 2 * hkv) * D // 2, H), "out": (H, hq * D // 2),
            "mlp_in": (mlp // 2, H)}
        assert out["placement"]["adaln"] == (cfg.depth, H, 6 * H // 2)


# ---- the split kernels' plain versions ----------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_split_plain_versions_join_to_the_whole(worlds, shape):
    """Per model group: B1's and B5's codes, joined over the ranks in rank
    order, and their row scales; B4's, B14's, B12's, B13's (the 512-wide
    MLP's one slab shared by the ranks, the 2560-wide's two slabs one a
    rank) and ``w8a8_dot``'s outputs on every rank; all bit-equal to the
    one-process functions, which are the whole kernels' plain versions."""
    from jatsr_torch.ops.attention import flash_out_plain
    from jatsr_torch.ops.int8_matmul import (matmul_prequant_plain, mlp_plain,
                                             quantize_rows)

    _, outs, solo, _ = worlds
    want = solo["splits"]
    M = shape[1]
    for g in range(shape[0]):
        ranks = outs[shape][g * M:(g + 1) * M]
        for name in ("b1", "b5"):
            codes = torch.cat([o["splits"][name][0] for o in ranks], dim=-1)
            assert torch.equal(codes, want[name][0]), name
            for o in ranks:
                assert torch.equal(o["splits"][name][1], want[name][1]), name
        for o in ranks:
            for name in ("b4", "xla", "b14", "b12", "b13_512", "b13_2560"):
                assert torch.equal(o["splits"][name], want[name]), name
    *_, a, wo, wso = w.split_inputs()
    assert torch.equal(want["b14"], matmul_prequant_plain(
        *quantize_rows(a), wo, wso))
    qkv, cos, sin, wo, wso, bo, a, mlps = w.more_split_inputs()
    assert torch.equal(want["b12"], flash_out_plain(qkv, cos, sin, wo, wso,
                                                    bo, 4, 2, n_valid=20))
    for n, ws in mlps.items():
        assert torch.equal(want[f"b13_{n}"], mlp_plain(a, *ws)), n


# ---- the forward --------------------------------------------------------


@pytest.mark.parametrize("path", list(w.PATHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_bit_equal_to_one_process(worlds, shape, path):
    """On a given AdaLN table, on every rank; the AdaLN tables gathered
    from the ranks' columns and the forward that computes its own rows
    block by block, the same."""
    _, outs, solo, _ = worlds
    want = solo["fwd"]
    for o in outs[shape]:
        for key in (path, f"{path}_tables", f"{path}_own_tables"):
            assert torch.equal(o["fwd"][key], want[key]), key


def test_flash_gate_takes_the_whole_models_heads(worlds):
    """At 984 patches tiny's 4/2 heads of 32 fail the flash-QKV gate and a
    rank's 2/1 at M = 2 pass it: each block of each rank takes the split
    q/k/v (the einsum past the gate), as one process does, and the forward
    is bit-equal to one process's."""
    from jatsr_torch.ops.attention import flash_supported

    _, outs, solo, _ = worlds
    assert not flash_supported(w.FAULT_N, 4, 2, 32)
    assert flash_supported(w.FAULT_N, 2, 1, 32)
    depth = get_preset("tiny").model.depth
    assert solo["fault"]["calls"] == {"einsum": depth, "flash_qkv": 0}
    for o in outs[(1, 2)]:
        assert o["fault"]["calls"] == solo["fault"]["calls"]
        assert torch.equal(o["fault"]["out"], solo["fault"]["out"])


def test_third_path_on_2x2_within_jax_bounds(worlds):
    """The third path's forward (B12, B13 and B14 split on each rank) on
    the (2, 2) mesh, computing its own AdaLN rows, against JAX's
    ``DiT.apply`` with its parameters placed by ``param_shardings`` on
    ``make_mesh(2, 2)``: within JAX's bounds for its mesh (atol 2e-2,
    relative L2 5e-2, ``tests/test_trainer_and_infer.py``)."""
    _, outs, _, jax_out = worlds
    want = jax_out["third"]
    for o in outs[(2, 2)]:
        got = o["fwd"]["opt_in_own_tables"].numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=2e-2)
        rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)
        assert rel < 5e-2, rel


# ---- the sampler --------------------------------------------------------


def test_sampler_on_2x2_within_jax_bounds(worlds):
    """The main path's sampler on three chunks at two Euler steps, CFG 2,
    on JAX's noise: every rank of the (2, 2) and (1, 2) meshes bit-equal
    to one process (tighter than JAX's bound for its own mesh against one
    device: atol 2e-2, relative L2 < 5e-2); against JAX's pipeline on its
    (2, 2) mesh, relative L2 < 5e-2, and a max of 6e-2, the bound of the
    port's pipeline against JAX's on one device
    (``tests/test_torch_pipeline.py``: the DiT's few-ulp cross-framework
    differences through CFG 2 and the denormalize; measured here 2.95e-2
    on 0.5 % of the entries past 2e-2)."""
    _, outs, solo, jax_out = worlds
    want = jax_out["serve"]
    for shape in SHAPES:
        for o in outs[shape]:
            assert torch.equal(o["serve"], solo["serve"]), shape
    got = outs[(2, 2)][0]["serve"].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=6e-2)
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)
    assert rel < 5e-2, rel


# ---- what the slice refuses ---------------------------------------------


def test_make_mesh_refuses_a_model_axis_that_does_not_divide():
    """A model axis that does not divide the kv heads is refused by the
    serving DiT's check, which it runs before it cuts its leaves: a mesh
    knows no model, so ``make_mesh`` checks only the world size."""
    cfg = w.serve_cfg(**w.PATHS["prologue"])  # 2 kv heads
    with pytest.raises(ValueError, match=r"kv heads \(2\)"):
        check_tensor_parallel(cfg, 4)


@pytest.mark.parametrize("knob", [
    w.PATHS[k] for k in ("opt_in", "split_flash", "pallas", "pallas2",
                         "int8_cli", "split_qkv", "int8_qk", "learned")])
def test_other_serving_branches_raise_on_a_model_axis(knob):
    """Each of this slice's branches serves at bf16 on a model axis (held
    bit-equal to one process by ``test_forward_bit_equal_to_one_process``);
    at the fp32 compute dtype it raises, naming the next slice."""
    cfg = dataclasses.replace(w.serve_cfg(**w.PATHS["prologue"]), **knob)
    check_tensor_parallel(cfg, 2, card=False)
    with pytest.raises(NotImplementedError,
                       match=r"next slice.* item 8\(b\)\(iii\)"):
        check_tensor_parallel(dataclasses.replace(cfg, dtype="float32"), 2,
                              card=False)


def test_a_rank_width_off_the_kernel_gate_raises():
    """v3 at M = 4 leaves a rank 448 qkv columns: the fused prologue's
    kernel takes multiples of 128."""
    cfg = dataclasses.replace(get_preset("v3").model,
                              matmul_precision="int8_static", fused_qkv=True,
                              fused_mlp=True, attention_impl="flash",
                              fused_prologue=True)
    check_tensor_parallel(cfg, 2)
    with pytest.raises(ValueError, match="448 qkv"):
        check_tensor_parallel(cfg, 4)


@pytest.mark.parametrize("knobs,share", [
    (dict(fused_qkv=False, int8_impl="pallas"), r"\[128, 64\] share of "
                                                r"q_proj"),
    (dict(fused_qkv=False, int8_impl="fused"), r"\[128, 64\] share of "
                                               r"q_proj")])
def test_a_rank_share_off_a_card_kernel_raises(knobs, share):
    """On the card a rank's share must fit the kernel the whole width
    takes: tiny's q_proj (128 columns, B14 or B4 on the card) leaves a rank
    at M = 2 64 columns, off the s8 GEMM's 128-column tiles.  On the CPU
    the plain versions take any share (the forward tests run this
    branch)."""
    cfg = dataclasses.replace(w.serve_cfg(**w.PATHS["prologue"]), **knobs)
    check_tensor_parallel(cfg, 2, card=False)
    with pytest.raises(ValueError, match=share):
        check_tensor_parallel(cfg, 2)
    v3 = dataclasses.replace(get_preset("v3").model, **{
        **w.PATHS["prologue"], "matmul_precision": "int8_static",
        "fused_mlp": True, **knobs})
    check_tensor_parallel(v3, 2)  # 640 q columns a rank


def test_training_on_a_model_axis_raises(tmp_path):
    """``DenseDiT`` trains on a model axis at bf16 and fp32 and under
    dynamic int8 on "xla", "fused" and "pallas"
    (``tests/test_torch_tp_train.py``); dynamic int8 at fp32 compute (the
    split int8 entries take bf16) raises, naming the next slice, as does
    an axis that does not divide the kv heads."""
    from jatsr_torch.models.dit import check_dense_tensor_parallel

    cfg = dataclasses.replace(get_preset("tiny").model,
                              matmul_precision="int8")
    for impl in ("xla", "fused", "pallas"):
        check_dense_tensor_parallel(dataclasses.replace(cfg, int8_impl=impl),
                                    2)
    check_dense_tensor_parallel(dataclasses.replace(cfg, dtype="float32",
                                                    matmul_precision="bf16"),
                                2)
    with pytest.raises(NotImplementedError,
                       match=r"split int8 entries take.* item 8\(b\)\(iii\)"):
        check_dense_tensor_parallel(dataclasses.replace(cfg, dtype="float32"),
                                    2)
    with pytest.raises(ValueError, match="does not divide the kv heads"):
        check_dense_tensor_parallel(cfg, 4)


def test_cli_infer_mesh_1_2_on_a_latent(worlds):
    """``cli.infer --int8 --fused-mlp --fused-prologue --attention flash
    --mesh 1 2`` at tiny: rank 0 writes the one-process CLI's wavs."""
    from jatsr_torch.utils.audio_io import load_wav

    root, *_ = worlds
    for name in ("song.lr_generated_cfg2.0.wav", "song.lr_lr_input.wav"):
        got, sr = load_wav(root / "cli_tp" / name)
        want, _ = load_wav(root / "cli_solo" / name)
        assert sr == 44100 and got.shape == (40 * 512,)
        np.testing.assert_array_equal(got, want)


def test_cli_infer_int8_defaults_mesh_1_2(worlds):
    """``cli.infer --int8 --mesh 1 2`` with the CLI's own int8 defaults
    (the einsum attention, fp32 scores, the unfused MLP) at tiny: rank 0
    writes the one-process CLI's wavs."""
    from jatsr_torch.utils.audio_io import load_wav

    root, *_ = worlds
    for name in ("song.lr_generated_cfg2.0.wav", "song.lr_lr_input.wav"):
        got, sr = load_wav(root / "cli_int8_tp" / name)
        want, _ = load_wav(root / "cli_int8_solo" / name)
        assert sr == 44100 and got.shape == (40 * 512,)
        np.testing.assert_array_equal(got, want)
