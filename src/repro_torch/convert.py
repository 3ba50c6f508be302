"""Move dense-transformer, SSM-stack and CNN weights between the JAX tree
and the port.

The JAX tree (``repro.models.transformer.init_params``, as numpy arrays) is
``{"embed", "final_norm", "head"?, "prefix": [], "blocks": (block,)}`` with
each block leaf stacked over ``n_blocks`` on axis 0: layer ``b·P + p`` is
``blocks[p][...][b]``. A block is ``{ln1, ln2, mixer: {wq, wk, wv, wo},
mlp: {wg, wi, wo}}`` for an attention layer with an MLP, and ``{ln1,
mixer: {in_proj, conv_w, conv_b, A_log, D, dt_bias, gnorm, out_proj},
mlp: {}}`` for an SSM layer without one (no ``ln2``). Both sides use the
``x @ W`` layout, so every leaf is copied as it is. bf16 leaves travel as
their raw 16-bit patterns.

The CNN tree (``repro.models.cnn.init_cnn``) is ``{"convs": [{w: (kh, kw,
in, out), b}], "dense": [{w: (in, out), b}]}``. The port keeps conv
weights as (out, in, kh, kw), so ``cnn_from_jax``/``cnn_to_jax`` permute
them; every other leaf, the first dense weight included, is copied as it
is (the port's CNN flattens in the reference's H, W, C order).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import stack_plan

_TOP = ("embed", "final_norm", "head")
_MIXER = {"attn": ("wq", "wk", "wv", "wo"),
          "ssm": ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                  "gnorm", "out_proj")}
_MLP = {"swiglu": ("wg", "wi", "wo"), "none": ()}


def _layer_keys(spec):
    """(path in the JAX block, name in the port's layer) of each leaf."""
    yield ("ln1",), "ln1"
    if spec.mlp != "none":
        yield ("ln2",), "ln2"
    for n in _MIXER[spec.mixer]:
        yield ("mixer", n), f"mixer.{n}"
    for n in _MLP[spec.mlp]:
        yield ("mlp", n), f"mlp.{n}"


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


def params_from_jax(tree, cfg) -> dict:
    """JAX param tree (numpy leaves) -> the port's ``state_dict``."""
    prefix, block, n_blocks = stack_plan(cfg)
    if len(tree.get("prefix", [])) != len(prefix):
        raise ValueError("prefix layers do not match the config")
    P = len(block)
    sd = {k: _to_torch(tree[k]) for k in _TOP if k in tree}
    for p, spec in enumerate(block):
        for path, name in _layer_keys(spec):
            leaf = np.asarray(_get(tree["blocks"][p], path))
            for b in range(n_blocks):
                sd[f"layers.{b * P + p}.{name}"] = _to_torch(leaf[b])
    return sd


def params_to_jax(state_dict, cfg) -> dict:
    """The port's ``state_dict`` -> JAX param tree with numpy leaves."""
    _, block, n_blocks = stack_plan(cfg)
    P = len(block)
    tree = {k: _to_numpy(state_dict[k]) for k in _TOP if k in state_dict}
    tree["prefix"] = []
    blocks = []
    for p, spec in enumerate(block):
        bp = {"mixer": {}, "mlp": {}}
        for path, name in _layer_keys(spec):
            leaf = np.stack([_to_numpy(state_dict[f"layers.{b * P + p}.{name}"])
                             for b in range(n_blocks)])
            if len(path) == 1:
                bp[path[0]] = leaf
            else:
                bp[path[0]][path[1]] = leaf
        blocks.append(bp)
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
