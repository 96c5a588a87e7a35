"""Convert pretrained PyTorch DAC weights to the codec's parameter tree.

The port's copy of the JAX package's ``models/dac/convert.py``; its output
is the JAX-layout numpy tree (``[K, in, out]`` kernels), which
:class:`models.dac.DAC` carries across to PyTorch's conv layouts
(``models/from_jax.py``).  The published DAC 44 kHz checkpoint stores
weight-normalised convs.  Conversion:

- fold ``w = g * v / ||v||`` (norm over all dims except torch's dim 0),
- transpose Conv1d ``[out, in, K]`` and ConvTranspose1d ``[in, out, K]``
  kernels into the channels-last ``[K, in, out]`` layout,
- squeeze Snake alphas ``[1, C, 1] -> [C]``.

Handles both the legacy ``weight_g``/``weight_v`` naming and the
``parametrizations.weight.original0/original1`` naming of newer torch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .model import DACConfig


def _fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (g.astype(np.float64) * v.astype(np.float64) / norm).astype(
        np.float32
    )


class _SDReader:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {
            k: (v.detach().cpu().numpy() if hasattr(v, "detach") else
                np.asarray(v))
            for k, v in sd.items()
        }
        self.used = set()

    def _get(self, key):
        self.used.add(key)
        return self.sd[key]

    def conv(self, prefix: str, transposed: bool = False) -> Dict:
        if f"{prefix}.weight_g" in self.sd:
            g = self._get(f"{prefix}.weight_g")
            v = self._get(f"{prefix}.weight_v")
        elif f"{prefix}.parametrizations.weight.original0" in self.sd:
            g = self._get(f"{prefix}.parametrizations.weight.original0")
            v = self._get(f"{prefix}.parametrizations.weight.original1")
        else:  # plain conv
            g, v = None, self._get(f"{prefix}.weight")
        w = _fold_weight_norm(g, v) if g is not None else v.astype(np.float32)
        # -> [K, in, out]
        w = w.transpose(2, 0, 1) if transposed else w.transpose(2, 1, 0)
        return {"w": w, "b": self._get(f"{prefix}.bias").astype(np.float32)}

    def alpha(self, prefix: str) -> np.ndarray:
        return self._get(f"{prefix}.alpha").reshape(-1).astype(np.float32)


def convert_torch_state_dict(
    state_dict: Dict, cfg: DACConfig | None = None
) -> Dict:
    """Torch DAC ``state_dict`` -> the codec's params tree (numpy)."""
    cfg = cfg or DACConfig()
    r = _SDReader(state_dict)
    params: Dict = {"encoder": {}, "quantizer": {}, "decoder": {}}

    def res_unit(prefix: str) -> Dict:
        return {
            "alpha1": r.alpha(f"{prefix}.block.0"),
            "conv1": r.conv(f"{prefix}.block.1"),
            "alpha2": r.alpha(f"{prefix}.block.2"),
            "conv2": r.conv(f"{prefix}.block.3"),
        }

    # Encoder: block.0 conv_in | block.1..n EncoderBlocks | Snake | conv_out.
    enc = params["encoder"]
    enc["conv_in"] = r.conv("encoder.block.0")
    n_enc = len(cfg.encoder_rates)
    for i in range(n_enc):
        base = f"encoder.block.{i + 1}.block"
        enc[f"block_{i}"] = {
            **{f"res_{j}": res_unit(f"{base}.{j}") for j in range(3)},
            "alpha": r.alpha(f"{base}.3"),
            "down": r.conv(f"{base}.4"),
        }
    enc["alpha_out"] = r.alpha(f"encoder.block.{n_enc + 1}")
    enc["conv_out"] = r.conv(f"encoder.block.{n_enc + 2}")

    # Residual VQ.
    for q in range(cfg.n_codebooks):
        base = f"quantizer.quantizers.{q}"
        params["quantizer"][f"vq_{q}"] = {
            "in_proj": r.conv(f"{base}.in_proj"),
            "out_proj": r.conv(f"{base}.out_proj"),
            "codebook": r._get(f"{base}.codebook.weight").astype(np.float32),
        }

    # Decoder: model.0 conv_in | model.1..n DecoderBlocks | Snake | conv_out
    # | Tanh.
    dec = params["decoder"]
    dec["conv_in"] = r.conv("decoder.model.0")
    n_dec = len(cfg.decoder_rates)
    for i in range(n_dec):
        base = f"decoder.model.{i + 1}.block"
        dec[f"block_{i}"] = {
            "alpha": r.alpha(f"{base}.0"),
            "up": r.conv(f"{base}.1", transposed=True),
            **{f"res_{j}": res_unit(f"{base}.{j + 2}") for j in range(3)},
        }
    dec["alpha_out"] = r.alpha(f"decoder.model.{n_dec + 1}")
    dec["conv_out"] = r.conv(f"decoder.model.{n_dec + 2}")
    return params


def load_torch_checkpoint(path: str, cfg: DACConfig | None = None) -> Dict:
    """Load a DAC checkpoint and convert.

    ``.pth`` (as published by descript): ``{"state_dict": ...}`` or a bare
    state dict; requires torch for unpickling.  ``.npz`` (written by
    :func:`save_params_npz`, e.g. via tools/import_reference.py): already
    converted — loads with numpy alone.
    """
    if str(path).endswith(".npz"):
        return load_params_npz(path)
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return convert_torch_state_dict(sd, cfg)


def save_params_npz(params: Dict, path: str) -> None:
    """Persist a converted DAC param tree as a flat ``.npz`` ("/"-joined
    keys), a reload format that needs numpy alone."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict:
    """Inverse of :func:`save_params_npz`."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out
