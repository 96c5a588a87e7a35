"""The port's whole DAC codec against the JAX package: encoder, residual VQ,
``decode_codes``, ``decode_from_codes``, the bf16 decode and the weight
converter.

The same weights (the JAX initializer's, as numpy) go to both sides.

- Encoder and quantizer: fp32 convolutions and products on both sides, so
  ``z_e`` and ``z_q`` agree to 1e-6 of their scale and the codes are equal.
- The bf16 decode rounds where JAX's does: at the tiny codec it is
  bit-equal to JAX's with XLA's excess precision off
  (``--xla_allow_excess_precision=false``: XLA then rounds to bf16 after
  every op, as PyTorch does).  With it on (JAX's default) XLA drops some
  bf16 round trips inside its fusions; and at wider convs the fp32 sums
  run in another order and move a rounding now and then, which the deep
  decoder carries on.  Either way the two differ by about bf16's own
  rounding: relative L2 < 2e-2 (measured 6e-3 to 8.8e-3; bf16 against
  fp32 is 7.8e-3 to 9.5e-3).
- The golden fixture (production geometry, weights of ``dac_mirror``
  through the port's converter): the bounds of ``tests/test_dac.py``'s own
  golden test, z_q within 3e-3 of its scale and more than 98 % of the codes
  equal.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jatsr_tpu.models.dac import DAC as JaxDAC
from jatsr_tpu.models.dac import DACConfig as JaxDACConfig
from jatsr_tpu.models.dac import convert as jax_convert
from jatsr_tpu.models.dac.model import decode_codes as jax_decode_codes
from jatsr_tpu.models.dac.model import init_params as jax_dac_init
from jatsr_torch.models.dac import DAC, DACConfig, init_params
from jatsr_torch.models.dac import convert
from jatsr_torch.ops import dac_kernels as dk

from dac_mirror import TorchDAC, mirror_state_dict, numpy_weights

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "dac_golden_44k.npz"
# tests/test_trainer_and_infer.py's tiny codec (latent 32, hop 8), and one
# with latent 256 whose decoder widths (64, 32) the fused kernels take.
TINY = dict(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=16,
            decoder_rates=(4, 2), n_codebooks=2, codebook_size=16,
            codebook_dim=4)
WIDE = dict(encoder_dim=64, encoder_rates=(2, 2), decoder_dim=128,
            decoder_rates=(2, 2), n_codebooks=4, codebook_size=32,
            codebook_dim=8)


def _jax_params(kw, seed=3):
    return jax.tree_util.tree_map(
        np.asarray, jax_dac_init(jax.random.PRNGKey(seed), JaxDACConfig(**kw)))


def _pair(kw, **torch_kw):
    p = _jax_params(kw)
    jdac = JaxDAC(jax.tree_util.tree_map(jnp.asarray, p), JaxDACConfig(**kw))
    return jdac, DAC(p, DACConfig(**kw), device="cpu", **torch_kw), p


def _audio(seed, B=2, T=300):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, T, 1))
            ).astype(np.float32)


def test_init_params_has_the_jax_layout():
    for kw in (TINY, WIDE, {}):
        want = jax.eval_shape(lambda k: jax_dac_init(k, JaxDACConfig(**kw)),
                              jax.random.PRNGKey(0))
        got = init_params(DACConfig(**kw), 0)
        assert jax.tree_util.tree_map(lambda a: a.shape, got) == \
            jax.tree_util.tree_map(lambda a: a.shape, want)
    # The decoder keeps the weights a decode-only codec of the seed had.
    from jatsr_torch.models.dac import init_decoder_params

    a = init_params(DACConfig(**TINY), 4)["decoder"]
    b = init_decoder_params(DACConfig(**TINY), 4)
    jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


@pytest.mark.parametrize("kw", [TINY, WIDE], ids=["tiny", "wide"])
def test_encoder_and_quantizer_match_jax(kw):
    jdac, tdac, _ = _pair(kw)
    cfg = DACConfig(**kw)
    audio = _audio(0, T=302)  # not a multiple of the hop: padded
    want = np.asarray(jdac.encode_continuous(jnp.asarray(audio)))
    got = tdac.encode_continuous(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, -(-302 // cfg.hop_length),
                                       cfg.latent_dim)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())

    zq_j, codes_j = jdac.encode(jnp.asarray(audio))
    zq_t, codes_t = tdac.encode(torch.from_numpy(audio))
    assert codes_t.dtype == torch.int32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(zq_t.numpy(), np.asarray(zq_j),
                               atol=1e-6 * np.abs(np.asarray(zq_j)).max())


def test_quantize_ties_go_to_the_first_code():
    """Rows 1-3 of the codebook point the same way: the cosine argmax is
    tied between them and takes row 1; the code's row itself (unnormalised)
    is what goes back through out_proj."""
    from jatsr_torch.models.dac import quantize

    eye = torch.eye(4)
    vq = {"in_proj": {"w": eye[:2, :, None].contiguous(),
                      "b": torch.zeros(2)},
          "out_proj": {"w": eye[:, :2, None].contiguous(),
                       "b": torch.zeros(4)},
          "codebook": torch.tensor([[0.0, 1.0], [1.0, 0.0], [1.0, 0.0],
                                    [2.0, 0.0]])}
    z = torch.tensor([[[3.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]]])
    z_q, codes = quantize({"vq_0": vq}, z, DACConfig(**TINY), n_quantizers=1)
    assert codes.tolist() == [[[1], [0]]]
    torch.testing.assert_close(z_q, torch.tensor([[[1.0, 0, 0, 0],
                                                   [0, 1.0, 0, 0]]]))


@pytest.mark.parametrize("kw", [TINY, WIDE], ids=["tiny", "wide"])
def test_decode_codes_and_decode_from_codes_match_jax(kw):
    jdac, tdac, p = _pair(kw)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, kw["codebook_size"], (2, 24, kw["n_codebooks"]),
                         dtype=np.int32)
    want = np.asarray(jax_decode_codes(jdac.params, jnp.asarray(codes),
                                       JaxDACConfig(**kw)))
    from jatsr_torch.models.dac import decode_codes

    got = decode_codes(tdac.quantizer, torch.from_numpy(codes),
                       DACConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    want_w = np.asarray(jdac.decode_from_codes(jnp.asarray(codes)))
    got_w = tdac.decode_from_codes(torch.from_numpy(codes)).numpy()
    assert got_w.shape == (2, 24 * DACConfig(**kw).hop_length, 1)
    np.testing.assert_allclose(got_w, want_w, atol=1e-5)


def test_encoder_never_takes_the_fused_units(monkeypatch):
    """The JAX encoder calls its residual units without ``fused``: the
    port's encoder runs none of the decode kernels, even on a codec built
    with ``fused_res_units`` whose encoder widths (64, 128) they take."""
    calls = []
    for name in ("res_unit_fused", "res_stage_fused",
                 "snake_conv_transpose_fused",
                 "snake_conv_transpose_streamed"):
        fn = getattr(dk, name)
        monkeypatch.setattr(dk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    # 4096 samples: block 0's units at C 64, T 4096 and block 1's at C
    # 128, T 2048, where the decode's gates admit the stage kernel.
    assert dk.res_stage_supported(64, 4096) and \
        dk.res_stage_supported(128, 2048)
    jdac, tdac, _ = _pair(WIDE, fused_res_units=True)
    tdac.encode(torch.from_numpy(_audio(2, B=1, T=4096)))
    assert calls == []
    tdac.decode(torch.zeros(1, 520, DACConfig(**WIDE).latent_dim))
    assert "res_stage_fused" in calls  # the decoder does take them


# JAX's bf16 decode of argv: config JSON, params .npz, z .npy, out .npy.
_BF16_JAX = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jatsr_tpu.models.dac import DAC, DACConfig
from jatsr_tpu.models.dac.convert import load_params_npz
kw = {k: tuple(v) if isinstance(v, list) else v
      for k, v in json.loads(sys.argv[1]).items()}
params = jax.tree_util.tree_map(jnp.asarray, load_params_npz(sys.argv[2]))
w = DAC(params, DACConfig(**kw), compute_dtype=jnp.bfloat16).decode(
    jnp.asarray(np.load(sys.argv[3])))
np.save(sys.argv[4], np.asarray(w))
"""


@pytest.mark.parametrize("kw", [TINY, WIDE], ids=["tiny", "wide"])
def test_bf16_decode_matches_jax(kw, tmp_path):
    p = _jax_params(kw)
    cfg = DACConfig(**kw)
    z = np.random.default_rng(2).standard_normal((1, 24, cfg.latent_dim)) \
        .astype(np.float32)
    with pytest.warns(UserWarning, match="fused_res_units requires fp32"):
        tdac = DAC(p, cfg, fused_res_units=True, device="cpu",
                   compute_dtype=torch.bfloat16)
    got = tdac.decode(torch.from_numpy(z)).numpy()
    assert got.dtype == np.float32 and got.shape == (1, 24 * cfg.hop_length,
                                                     1)
    if kw is TINY:
        # JAX with XLA rounding after every bf16 op, as PyTorch does.
        convert.save_params_npz(p, tmp_path / "p.npz")
        np.save(tmp_path / "z.npy", z)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false",
                   PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-c", _BF16_JAX, json.dumps(kw),
             str(tmp_path / "p.npz"), str(tmp_path / "z.npy"),
             str(tmp_path / "w.npy")], env=env, capture_output=True,
            text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        np.testing.assert_array_equal(got, np.load(tmp_path / "w.npy"))
    # JAX as it runs by default (excess precision on).
    jdac = JaxDAC(jax.tree_util.tree_map(jnp.asarray, p), JaxDACConfig(**kw),
                  compute_dtype=jnp.bfloat16)
    want = np.asarray(jdac.decode(jnp.asarray(z)))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2
    # ... and it is a bf16 decode, not the fp32 one.
    fp32 = DAC(p, cfg, device="cpu").decode(torch.from_numpy(z)).numpy()
    assert np.linalg.norm(got - fp32) / np.linalg.norm(fp32) > 1e-3


def _state_dict(cfg, seed, parametrizations=False):
    tmodel = TorchDAC(cfg).eval()
    numpy_weights(tmodel, seed=seed)
    sd = mirror_state_dict(tmodel)
    if parametrizations:  # newer torch's weight-norm naming
        sd = {k.replace("weight_g", "parametrizations.weight.original0")
              .replace("weight_v", "parametrizations.weight.original1"): v
              for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("parametrizations", [False, True])
def test_converter_is_bit_equal_to_jax(parametrizations, tmp_path):
    cfg = DACConfig(**TINY)
    sd = _state_dict(JaxDACConfig(**TINY), 5, parametrizations)
    want = jax_convert.convert_torch_state_dict(sd, JaxDACConfig(**TINY))
    got = convert.convert_torch_state_dict(sd, cfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    # .pth and .npz round trips load the same tree.
    torch.save({"state_dict": sd}, tmp_path / "w.pth")
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.load_torch_checkpoint(tmp_path / "w.pth",
                                                         cfg), want)
    convert.save_params_npz(got, tmp_path / "w.npz")
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.load_torch_checkpoint(
                               str(tmp_path / "w.npz")), want)


def test_encode_of_the_golden_fixture():
    """Production geometry (1024-channel latent, rates 2/4/8/8, nine
    codebooks): the fixture's weights through the port's converter, its
    audio through the port's encode."""
    data = np.load(FIXTURE)
    cfg = DACConfig()
    sd = _state_dict(JaxDACConfig(), int(data["weight_seed"]))
    codec = DAC(convert.convert_torch_state_dict(sd, cfg), cfg, device="cpu")
    audio = data["audio"].transpose(0, 2, 1)  # [1, T, 1]
    z_q, codes = codec.encode(torch.from_numpy(audio))
    z_q = z_q.numpy().transpose(0, 2, 1)
    scale = np.abs(data["z_q"]).max()
    np.testing.assert_allclose(z_q, data["z_q"], atol=3e-3 * scale)
    assert (codes.numpy() == data["codes"]).mean() > 0.98
    z_e = codec.encode_continuous(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(z_e.transpose(0, 2, 1), data["z_e"],
                               atol=3e-4 * np.abs(data["z_e"]).max())


def test_pad_audio_and_decode_only_codecs():
    cfg = DACConfig(**TINY)
    codec = DAC.random_init(0, cfg, device="cpu")
    z, codes = codec.encode(torch.zeros(1, 21, 1))
    assert z.shape == (1, 3, cfg.latent_dim) and codes.shape == (1, 3, 2)
    from jatsr_torch.models.dac import init_decoder_params

    dec_only = DAC(init_decoder_params(cfg), cfg, device="cpu")
    with pytest.raises(ValueError, match="decoder weights only"):
        dec_only.encode(torch.zeros(1, 8, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DAC.random_init(0, cfg, device="cpu", compute_dtype=torch.bfloat16)
