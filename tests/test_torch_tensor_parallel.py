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
- the split plain versions of B1, B5 and B4 (and ``w8a8_dot``'s torch
  ops), joined over the ranks, bit-equal to the one-process functions;
- the DiT forward on a given AdaLN table, on bench.py's default path and
  on --no-fused-prologue, bit-equal to one process on both meshes: every
  split adds int32 partial products or takes row maxima, exact in any
  order, and each head and column is computed alone;
- the sampler on (2, 2) bit-equal to one process, and against JAX's
  ``InferencePipeline`` on its own ``make_mesh(2, 2)`` (virtual CPU
  devices) within relative L2 5e-2 (JAX's bound for its mesh,
  ``tests/test_trainer_and_infer.py``) and the max of the port's pipeline
  against JAX's (``tests/test_torch_pipeline.py``, 6e-2);
- what the slice refuses: a model axis that does not divide the kv heads,
  the other serving branches, dynamic int8 training on B14 or at fp32;
- ``cli.infer --mesh 1 2`` on a ``.npy`` latent: the one-process CLI's wav
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
    return dataclasses.replace(
        jax_get_preset("tiny").model, bottleneck_dim=128,
        input_channels=w.C, cond_channels=w.C, norm="rms",
        matmul_precision="int8_static", attention_impl="flash",
        fused_qkv=True, fused_mlp=True, **knobs)


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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("tensor_parallel")
    noise, want = _jax_pipeline_case()
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
    return root, outs, solo, want


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
    order, and their row scales; B4's and ``w8a8_dot``'s outputs on every
    rank; all bit-equal to the one-process functions."""
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
            for name in ("b4", "xla"):
                assert torch.equal(o["splits"][name], want[name]), name


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
    _, outs, solo, want = worlds
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
    dict(attention_impl="xla"), dict(fused_qkv=False),
    dict(fused_mlp_impl="full"), dict(flash_int8_qk=True),
    dict(quantize_head=True), dict(dtype="float32"),
    dict(int8_impl="pallas"), dict(fused_mlp=False)])
def test_other_serving_branches_raise_on_a_model_axis(knob):
    cfg = dataclasses.replace(w.serve_cfg(**w.PATHS["prologue"]), **knob)
    with pytest.raises(NotImplementedError, match="next slice"):
        check_tensor_parallel(cfg, 2)


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


def test_training_on_a_model_axis_raises(tmp_path):
    """``DenseDiT`` trains on a model axis at bf16 and fp32 and under
    dynamic int8 on "xla" and "fused" (``tests/test_torch_tp_train.py``);
    dynamic int8 on B14 (not split) or at fp32 compute (the split int8
    entries take bf16) raises, as does an axis that does not divide the kv
    heads."""
    from jatsr_torch.models.dit import check_dense_tensor_parallel

    cfg = dataclasses.replace(get_preset("tiny").model,
                              matmul_precision="int8")
    for impl in ("xla", "fused"):
        check_dense_tensor_parallel(dataclasses.replace(cfg, int8_impl=impl),
                                    2)
    check_dense_tensor_parallel(dataclasses.replace(cfg, dtype="float32",
                                                    matmul_precision="bf16"),
                                2)
    for knobs, match in (({"int8_impl": "pallas"}, "B14 is not split"),
                         ({"dtype": "float32"}, "split int8 entries take")):
        with pytest.raises(NotImplementedError,
                           match=rf"{match}.* item 8\(b\)\(ii\)"):
            check_dense_tensor_parallel(dataclasses.replace(cfg, **knobs), 2)
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
