"""Move zoo, architecture and CNN weights between the JAX tree and the port.

The JAX tree (``repro.models.transformer.init_params``, as numpy arrays) is
``{"embed", "final_norm", "head"?, "prefix": [layer], "blocks": (block,)}``
and, for an enc-dec model, ``"encoder"`` (one layer stacked over
``encoder_layers``), ``"enc_final_norm"``, ``"enc_pos"`` and
``"pos_embed"``. ``prefix`` holds the ``first_dense`` layers unstacked;
each leaf of ``blocks[p]`` is stacked over ``n_blocks`` on axis 0, so layer
``first_dense + b·P + p`` is ``blocks[p][...][b]``. A layer is ``{ln1,
mixer: {...}, mlp: {...}}`` with ``ln2`` where it has an MLP (``mlp`` is
``{}`` where it has none) and ``ln_x``, ``cross: {wq, wk, wv, wo}`` in an
enc-dec decoder; the leaves of ``mixer`` and ``mlp`` are those of its kind
(``_MIXER``, ``_MLP``). Both sides use the ``x @ W`` layout, so every leaf
is copied as it is. bf16 leaves travel as their raw 16-bit patterns.

The CNN tree (``repro.models.cnn.init_cnn``) is ``{"convs": [{w: (kh, kw,
in, out), b}], "dense": [{w: (in, out), b}]}``. The port keeps conv
weights as (out, in, kh, kw), so ``cnn_from_jax``/``cnn_to_jax`` permute
them; every other leaf, the first dense weight included, is copied as it
is (the port's CNN flattens in the reference's H, W, C order).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import ENCODER_SPEC, stack_plan

_TOP = ("embed", "final_norm", "head", "enc_final_norm", "enc_pos",
        "pos_embed")
_MIXER = {"attn": ("wq", "wk", "wv", "wo"),
          "mla": ("wq", "wkv_a", "wk_b", "wv_b", "wo", "kv_norm"),
          "ssm": ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                  "gnorm", "out_proj")}
_MLP = {"swiglu": ("wg", "wi", "wo"), "gelu2": ("wi", "wo"),
        "moe": ("router", "wg", "wi", "wo"), "none": ()}
_SHARED = ("swg", "swi", "swo")


def _layer_keys(spec, cfg):
    """(path in the JAX layer, name in the port's layer) of each leaf."""
    yield ("ln1",), "ln1"
    if spec.mlp != "none":
        yield ("ln2",), "ln2"
    for n in _MIXER[spec.mixer]:
        yield ("mixer", n), f"mixer.{n}"
    mlp = _MLP[spec.mlp]
    if spec.mlp == "moe" and cfg.num_shared_experts:
        mlp += _SHARED
    for n in mlp:
        yield ("mlp", n), f"mlp.{n}"
    if spec.cross:
        yield ("ln_x",), "ln_x"
        for n in _MIXER["attn"]:
            yield ("cross", n), f"cross.{n}"


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 dtype; needed only for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacks(cfg):
    """(JAX path, port prefix, spec, layer count, first index, stride) of
    each stacked group of layers: block position p, then the encoder."""
    prefix, block, n_blocks = stack_plan(cfg)
    P, f = len(block), len(prefix)
    for p, spec in enumerate(block):
        yield ("blocks", p), "layers", spec, n_blocks, f + p, P
    if cfg.family == "encdec":
        yield ("encoder",), "encoder", ENCODER_SPEC, cfg.encoder_layers, 0, 1


def params_from_jax(tree, cfg) -> dict:
    """JAX param tree (numpy leaves) -> the port's ``state_dict``."""
    prefix, _, _ = stack_plan(cfg)
    if len(tree.get("prefix", [])) != len(prefix):
        raise ValueError("prefix layers do not match the config")
    sd = {k: _to_torch(tree[k]) for k in _TOP if k in tree}
    for i, spec in enumerate(prefix):
        for path, name in _layer_keys(spec, cfg):
            sd[f"layers.{i}.{name}"] = _to_torch(_get(tree["prefix"][i], path))
    for key, port, spec, n, first, stride in _stacks(cfg):
        for path, name in _layer_keys(spec, cfg):
            leaf = np.asarray(_get(_get(tree, key), path))
            for b in range(n):
                sd[f"{port}.{first + b * stride}.{name}"] = _to_torch(leaf[b])
    return sd


def _nest(leaves: dict) -> dict:
    """{path: leaf} -> a JAX layer dict; ``mixer`` and ``mlp`` always
    present (``mlp`` empty for a layer without one)."""
    layer = {"mixer": {}, "mlp": {}}
    for path, leaf in leaves.items():
        if len(path) == 1:
            layer[path[0]] = leaf
        else:
            layer.setdefault(path[0], {})[path[1]] = leaf
    return layer


def params_to_jax(state_dict, cfg) -> dict:
    """The port's ``state_dict`` -> JAX param tree with numpy leaves."""
    prefix, _, _ = stack_plan(cfg)
    tree = {k: _to_numpy(state_dict[k]) for k in _TOP if k in state_dict}
    tree["prefix"] = [
        _nest({path: _to_numpy(state_dict[f"layers.{i}.{name}"])
               for path, name in _layer_keys(spec, cfg)})
        for i, spec in enumerate(prefix)]
    blocks = []
    for key, port, spec, n, first, stride in _stacks(cfg):
        layer = _nest({path: np.stack([
            _to_numpy(state_dict[f"{port}.{first + b * stride}.{name}"])
            for b in range(n)]) for path, name in _layer_keys(spec, cfg)})
        if key[0] == "blocks":
            blocks.append(layer)
        else:
            tree["encoder"] = layer
    tree["blocks"] = tuple(blocks)
    return tree


def cnn_from_jax(tree) -> dict:
    """JAX CNN tree (numpy leaves) -> the port's ``CNN`` ``state_dict``."""
    sd = {}
    for i, c in enumerate(tree["convs"]):
        sd[f"convs.{i}.w"] = _to_torch(np.transpose(np.asarray(c["w"]),
                                                    (3, 2, 0, 1)))
        sd[f"convs.{i}.b"] = _to_torch(c["b"])
    for i, d in enumerate(tree["dense"]):
        sd[f"dense.{i}.w"] = _to_torch(d["w"])
        sd[f"dense.{i}.b"] = _to_torch(d["b"])
    return sd


def cnn_to_jax(state_dict) -> dict:
    """The port's ``CNN`` ``state_dict`` -> JAX CNN tree (numpy leaves)."""
    def count(prefix):
        return len({k.split(".")[1] for k in state_dict
                    if k.startswith(prefix + ".")})
    convs = [{"w": np.transpose(_to_numpy(state_dict[f"convs.{i}.w"]),
                                (2, 3, 1, 0)).copy(),
              "b": _to_numpy(state_dict[f"convs.{i}.b"])}
             for i in range(count("convs"))]
    dense = [{"w": _to_numpy(state_dict[f"dense.{i}.w"]),
              "b": _to_numpy(state_dict[f"dense.{i}.b"])}
             for i in range(count("dense"))]
    return {"convs": convs, "dense": dense}
