"""Convert reference JaT_AudioSR_V2/V3 PyTorch checkpoints to the DiT's
parameter tree.

The port's copy of the JAX package's ``models/convert_dit.py``.  It lets a
user of the reference bring their trained checkpoints (``model_state_dict``
with optional ``module.``/``_orig_mod.`` prefixes) straight in.  The output
is the JAX-layout numpy tree (``blocks`` stacked ``[depth, ...]``, kernels
``[in, out]``), which ``models.dit.DenseDiT`` takes as it is and
``ops.quant.quantize_params_static`` turns into the int8 serving tree.

Beyond the usual ``[out, in] -> [in, out]`` transposes and per-layer
stacking of the blocks, two layout permutations are needed because this
framework patchifies **time-major**:

- patch input ordering: reference flattens a patch as ``c * P + p``
  (jat_audiosr_v2.py:224-227), ours as ``p * C + c`` — the first patch
  Linear's input rows are permuted accordingly;
- final projection output ordering: reference unpatchifies ``c * P + p``
  (jat_audiosr_v2.py:383-397), ours ``p * C + c`` — its output columns are
  permuted.

Key map (reference -> here):
  patch_embed.proj.0    -> patch_in        (with input permutation)
  patch_embed.proj.2    -> patch_out
  t_embedder.1 / .3     -> t_mlp1 / t_mlp2
  blocks.i.attn.{q,k,v,out}_proj -> blocks/attn/{q,k,v,out}_proj (stacked)
  blocks.i.adaLN_modulation.1    -> blocks/adaln (stacked)
  blocks.i.mlp.0 / .3   -> blocks/mlp_in / mlp_out (stacked)
  final_layer.1         -> final_proj      (with output permutation)
(norms are affine-free on both sides: no parameters.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs import ModelConfig


def _strip_prefixes(sd: Dict) -> Dict:
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _patch_input_perm(P: int, C2: int) -> np.ndarray:
    """perm[j] = reference input index for our input position j, where
    j = p * C2 + c and the reference index is c * P + p."""
    p = np.arange(P * C2) // C2
    c = np.arange(P * C2) % C2
    return c * P + p


def _patch_output_perm(P: int, C: int) -> np.ndarray:
    p = np.arange(P * C) // C
    c = np.arange(P * C) % C
    return c * P + p


def convert_dit_state_dict(state_dict: Dict, cfg: ModelConfig) -> Dict:
    """Reference ``model_state_dict`` -> the DiT's params tree (numpy)."""
    sd = {k: _np(v) for k, v in _strip_prefixes(state_dict).items()}
    P = cfg.patch_len
    C = cfg.input_channels
    C2 = cfg.input_channels + cfg.cond_channels

    def lin_kernel(key):  # torch [out, in] -> [in, out]
        return sd[key].astype(np.float32).T

    params: Dict = {}

    w = lin_kernel("patch_embed.proj.0.weight")  # [P*C2(ref order), bneck]
    params["patch_in"] = {
        "kernel": w[_patch_input_perm(P, C2)],
        "bias": sd["patch_embed.proj.0.bias"].astype(np.float32),
    }
    params["patch_out"] = {
        "kernel": lin_kernel("patch_embed.proj.2.weight"),
        "bias": sd["patch_embed.proj.2.bias"].astype(np.float32),
    }
    params["t_mlp1"] = {
        "kernel": lin_kernel("t_embedder.1.weight"),
        "bias": sd["t_embedder.1.bias"].astype(np.float32),
    }
    params["t_mlp2"] = {
        "kernel": lin_kernel("t_embedder.3.weight"),
        "bias": sd["t_embedder.3.bias"].astype(np.float32),
    }

    def stack(fmt, transform=lin_kernel):
        return np.stack(
            [transform(fmt.format(i)) for i in range(cfg.depth)], axis=0
        )

    def stack_bias(fmt):
        return np.stack(
            [sd[fmt.format(i)].astype(np.float32) for i in range(cfg.depth)],
            axis=0,
        )

    blocks: Dict = {
        "attn": {
            name: {"kernel": stack(f"blocks.{{}}.attn.{name}.weight")}
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")
        },
        "adaln": {
            "kernel": stack("blocks.{}.adaLN_modulation.1.weight"),
            "bias": stack_bias("blocks.{}.adaLN_modulation.1.bias"),
        },
        "mlp_in": {
            "kernel": stack("blocks.{}.mlp.0.weight"),
            "bias": stack_bias("blocks.{}.mlp.0.bias"),
        },
        "mlp_out": {
            "kernel": stack("blocks.{}.mlp.3.weight"),
            "bias": stack_bias("blocks.{}.mlp.3.bias"),
        },
    }
    params["blocks"] = blocks

    out_perm = _patch_output_perm(P, C)
    fw = lin_kernel("final_layer.1.weight")  # [H, P*C(ref order)]
    params["final_proj"] = {
        "kernel": fw[:, out_perm],
        "bias": sd["final_layer.1.bias"].astype(np.float32)[out_perm],
    }
    return params


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> Dict:
    """Load a reference ``.pt`` training checkpoint and convert the model
    weights (requires torch for unpickling)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    return convert_dit_state_dict(sd, cfg)
