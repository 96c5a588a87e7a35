"""Weight bridge from the JAX package's parameter trees, and the port's own
seeded random weights.

The JAX parameters arrive as nested dicts of numpy arrays (bf16 leaves as
numpy's extended ``bfloat16`` dtype), so the port never imports JAX:

- the DiT tree keeps the JAX layout: scanned ``blocks`` stacks
  ``[depth, ...]``, Dense kernels ``[in, out]``, int8_static leaves
  ``kernel_q`` ``[K, N]`` / ``kernel_scale`` ``[1, N]`` / ``bias``.
  :class:`models.dit.DiT` takes it as it is;
- the DAC dicts (encoder, quantizer, decoder: ``{"w": [K, Cin, Cout],
  "b", "alpha", "codebook"}``) are permuted to PyTorch's conv layouts:
  ``[Cout, Cin, K]`` for a convolution, ``[Cin, Cout, K]`` for the
  transposed convolutions (the ``up`` layers);
  for the fused decode, :func:`dac_fused_pack` also keeps the kernels'
  weights as bf16 in the JAX layout.

:func:`random_dense_params` makes a dense DiT tree from a seed, for runs on
a machine without JAX: the JAX init zeroes ``adaln`` and ``final_proj``
(AdaLN-Zero), which would make the DiT the identity and every comparison
vacuous, so here they get std 0.02.  :func:`init_dense_params` draws the
tree as flax initialises it, for training from scratch;
:func:`dense_tree_from_module` reads a trained ``DenseDiT`` back out in the
JAX layout, and :func:`train_state_from_jax` carries a JAX train state
(parameters and AdamW moments) into the port's.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(a) -> torch.Tensor:
    """A numpy array (bf16 included) or tensor as a tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def tree_to_torch(tree: dict, device="cpu") -> dict:
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    return {k: tree_to_torch(v, device) if isinstance(v, dict)
            else as_tensor(v).to(device) for k, v in tree.items()}


def dac_tree_from_jax(tree: dict, device="cpu",
                      dtype=torch.float32) -> dict:
    """A JAX DAC dict (the encoder's, the quantizer's or the decoder's) ->
    the same dict with PyTorch conv layouts, every leaf in ``dtype`` (the
    JAX codec casts its decoder to its compute dtype once).  The
    codebooks keep their ``[size, dim]`` layout."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "w" in v:
            w = as_tensor(v["w"]).float()
            w = w.permute(1, 2, 0) if k == "up" else w.permute(2, 1, 0)
            out[k] = {"w": w.contiguous().to(device, dtype),
                      "b": as_tensor(v["b"]).to(device, dtype)}
        elif isinstance(v, dict):
            out[k] = dac_tree_from_jax(v, device, dtype)
        else:
            out[k] = as_tensor(v).to(device, dtype)
    return out


def dac_fused_pack(dec: dict, device="cpu") -> dict:
    """The weights the fused decode kernels read, packed once: per decoder
    block ``{"up_w": bf16 [K, Cin, Cout]}`` for the polyphase upsample
    (B7, B8) and, where the block's width is one the residual-unit kernels
    take (C <= 384), ``w7s`` bf16 ``[3, 7, C, C]``, ``w1s`` bf16
    ``[3, C, C]`` (the JAX layout, ``[K, Cin, Cout]``) and fp32 ``b7s``,
    ``b1s``, ``a1s``, ``a2s`` ``[3, C]`` (B6, B9)."""
    out = {}
    for name, blk in dec.items():
        if not name.startswith("block_"):
            continue
        up_w = as_tensor(blk["up"]["w"]).to(device, torch.bfloat16)
        packed = {"up_w": up_w}
        units = [blk[f"res_{j}"] for j in range(3)]
        c = as_tensor(units[0]["alpha1"]).shape[0]
        if c <= 384:
            def stack(path, dtype):
                leaves = []
                for u in units:
                    for key in path:
                        u = u[key]
                    leaves.append(as_tensor(u).to(device, dtype))
                return torch.stack(leaves)

            packed.update(
                w7s=stack(("conv1", "w"), torch.bfloat16),
                w1s=stack(("conv2", "w"), torch.bfloat16).reshape(3, c, c),
                b7s=stack(("conv1", "b"), torch.float32),
                b1s=stack(("conv2", "b"), torch.float32),
                a1s=stack(("alpha1",), torch.float32),
                a2s=stack(("alpha2",), torch.float32))
        out[name] = packed
    return out


def random_dense_params(cfg, seed: int = 0) -> dict:
    """A dense DiT param tree (the layout of ``matmul_precision="bf16"``,
    separate q/k/v) as fp32 numpy, from ``seed``.

    Projections are normal with std ``1/sqrt(fan_in)``; biases, ``adaln``,
    ``final_proj`` and the learned positions (``pos_embed [max_len, H]``
    where ``cfg.pos_embed == "learned"``) normal with std 0.02.  Feed it to
    ``ops.quant.quantize_params_static(tree, cfg)`` for the int8_static
    tree of ``cfg``; the dynamic-int8 model (``DenseDiT`` under
    ``matmul_precision="int8"``) takes it as it is.
    """
    rng = np.random.default_rng(seed)

    def leaf(path, shape, fan_in, kind):
        std = fan_in ** -0.5 if kind == "kernel" else 0.02
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return _build_tree(cfg, leaf)


def _dense_layout(cfg) -> dict:
    """``{path: (shape, kind)}`` of every leaf of the dense DiT tree, in
    the JAX init's order; ``shape`` is one block's under ``blocks``; kind
    is "kernel" (a projection), "zero" (biases, and the AdaLN-Zero
    ``adaln`` and ``final_proj`` kernels) or "pos" (the learned positions,
    normal with std 0.02)."""
    H, P, C = cfg.hidden_size, cfg.patch_len, cfg.input_channels
    hd, hq, hkv = cfg.head_dim, cfg.num_q_heads, cfg.num_kv_heads
    mlp = int(H * cfg.mlp_ratio)
    out = {}

    def dense(path, fan_in, fan_out, bias=True, zero=False):
        out[path + ("kernel",)] = ((fan_in, fan_out),
                                   "zero" if zero else "kernel")
        if bias:
            out[path + ("bias",)] = ((fan_out,), "zero")

    dense(("patch_in",), P * 2 * C, cfg.bottleneck_dim)
    dense(("patch_out",), cfg.bottleneck_dim, H)
    if cfg.pos_embed == "learned":
        out[("pos_embed",)] = ((cfg.max_len, H), "pos")
    dense(("t_mlp1",), H, H)
    dense(("t_mlp2",), H, H)
    dense(("blocks", "adaln"), H, 6 * H, zero=True)
    ab = cfg.attention_bias
    for name, fi, fo in (("q_proj", H, hq * hd), ("k_proj", H, hkv * hd),
                         ("v_proj", H, hkv * hd), ("out_proj", hq * hd, H)):
        dense(("blocks", "attn", name), fi, fo, bias=ab)
    dense(("blocks", "mlp_in"), H, mlp)
    dense(("blocks", "mlp_out"), mlp, H)
    dense(("final_proj",), H, P * C, zero=True)
    return out


def _build_tree(cfg, leaf) -> dict:
    """The dense tree with ``leaf(path, shape, fan_in, kind)`` at every
    path, in the layout's order (``shape`` has the depth axis on the
    ``blocks`` leaves)."""
    tree: dict = {}
    for path, (shape, kind) in _dense_layout(cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        full = ((cfg.depth,) if path[0] == "blocks" else ()) + shape
        node[path[-1]] = leaf(path, full, shape[0], kind)
    return tree


def init_dense_params(cfg, generator: torch.Generator) -> dict:
    """The dense DiT tree (JAX layout, fp32 CPU tensors) drawn as flax
    initialises it: ``lecun_normal`` kernels (a normal truncated to
    [-2, 2], times ``sqrt(1 / fan_in) / 0.8796``), zero biases, zero
    ``adaln`` and ``final_proj`` (AdaLN-Zero), learned positions normal
    with std 0.02.  The numbers differ from JAX's (another generator); the
    distribution is the same."""
    std_of_truncated = 0.87962566103423978  # std of N(0, 1) cut at +-2

    def leaf(path, shape, fan_in, kind):
        t = torch.zeros(shape, dtype=torch.float32)
        if kind == "kernel":
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            t.mul_(fan_in ** -0.5 / std_of_truncated)
        elif kind == "pos":
            t.normal_(0.0, 0.02, generator=generator)
        return t

    return _build_tree(cfg, leaf)


def dense_tree_from_module(model) -> dict:
    """A ``DenseDiT``'s parameters as the JAX float tree of fp32 numpy
    arrays (block leaves stacked ``[depth, ...]``); bf16 parameters come
    out as their exact values, so a bf16 tree goes in and out bit for
    bit."""
    return dense_tree_from_named(dict(model.named_parameters()), model.cfg)


def dense_tree_from_named(named: dict, cfg) -> dict:
    """Tensors keyed by ``DenseDiT`` parameter name (``blocks.3.mlp_in.
    kernel``...; a checkpoint's ``params``) -> the JAX float tree of fp32
    numpy arrays."""
    named = {k: v.detach().float().cpu().numpy() for k, v in named.items()}

    def leaf(path, shape, fan_in, kind):
        if path[0] != "blocks":
            return named[".".join(path)]
        rest = ".".join(path[1:])
        return np.stack([named[f"blocks.{i}.{rest}"]
                         for i in range(cfg.depth)])

    return _build_tree(cfg, leaf)


def named_from_tree(tree: dict, prefix: str = "") -> dict:
    """A JAX dense tree -> tensors keyed by ``DenseDiT`` parameter name
    (copies): each ``blocks`` leaf ``[depth, ...]`` is cut into
    ``blocks.<i>.<path>``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(named_from_tree(v, name + "."))
        elif name.startswith("blocks."):
            t = _copy(v)
            rest = name[len("blocks."):]
            out.update({f"blocks.{i}.{rest}": t[i] for i in range(len(t))})
        else:
            out[name] = _copy(v)
    return out


def _copy(a) -> torch.Tensor:
    """A tensor that owns a copy of ``a`` (a numpy array, read-only ones
    too, or a tensor)."""
    return a.clone() if isinstance(a, torch.Tensor) else as_tensor(np.array(a))


def _adam_state(opt_state):
    """The first node of an optax state that carries ``mu`` and ``nu``
    (``ScaleByAdamState``), found through its tuples."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(params: dict, opt_state, step: int,
                         seed: int = 0) -> dict:
    """A JAX ``TrainState``'s ``params``, ``opt_state`` and ``step`` (numpy,
    e.g. through ``jax.device_get``) as the port's train-state dict
    (``TrainState.state_dict``'s layout, CPU tensors), for
    ``TrainState.load_state_dict``: the optax chain's ``ScaleByAdamState``
    count, mu and nu become AdamW's count and moments.  ``seed`` is the
    port's: its per-step draws do not come from the JAX key."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments")
    return {"step": int(np.asarray(step)), "seed": int(seed),
            "params": named_from_tree(params),
            "opt": {"count": int(np.asarray(adam.count)),
                    "mu": named_from_tree(adam.mu),
                    "nu": named_from_tree(adam.nu)}}
