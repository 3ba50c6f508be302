"""Decoder-only stack for the dense and ssm families: parameters, forward,
head and LM loss.

Port of the dense and ssm paths of ``repro.models.transformer``. The model
is an ``nn.Module`` whose weights keep the JAX layout; its ``state_dict``
names are ``embed``, ``final_norm``, ``head`` (untied only) and, per layer,
``layers.{i}.ln1``, ``layers.{i}.mixer.*`` (attention ``wq, wk, wv, wo``;
SSM ``in_proj, conv_w, conv_b, A_log, D, dt_bias, gnorm, out_proj``) and,
where the layer has an MLP, ``layers.{i}.{ln2, mlp.{wg, wi, wo}}``
(``repro_torch.convert`` maps them to and from the JAX tree).

``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, one layer per checkpoint as the JAX package
checkpoints one block), so under ``kernels="cuda"`` the mixer's kernel
(attention or SSD) runs twice per layer per loss-and-gradient: once in the
forward and once in the recomputation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import ssm as S

LOSS_CHUNK = 512
FAMILIES = ("dense", "ssm")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                   # 'attn' | 'ssm'
    window: Optional[int]
    mlp: str                     # 'swiglu' | 'none'


def _mixer_for(cfg) -> tuple:
    if cfg.family == "ssm":
        return "ssm", None
    return "attn", cfg.sliding_window


def _mlp_for(cfg) -> str:
    return "none" if cfg.d_ff == 0 else "swiglu"    # mamba2: mixer-only layers


def layer_spec(cfg) -> LayerSpec:
    """The layer of the dense and ssm families, the same at every depth."""
    mixer, window = _mixer_for(cfg)
    return LayerSpec(mixer, window, _mlp_for(cfg))


def stack_plan(cfg):
    """-> (prefix_specs, block_specs, n_blocks); the dense and ssm families
    have no prefix and a one-layer block."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return [], [layer_spec(cfg)], cfg.num_layers


def _dense(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _f32(shape, device):
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


def _attn_params(cfg, dtype, device):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": _dense((d, H * hd), dtype, device),
            "wk": _dense((d, K * hd), dtype, device),
            "wv": _dense((d, K * hd), dtype, device),
            "wo": _dense((H * hd, d), dtype, device)}


def _ssm_params(cfg, dtype, device):
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cch = S.conv_channels(cfg)
    return {"in_proj": _dense((d, 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state
                               + nh), dtype, device),
            "conv_w": _dense((cfg.conv_width, cch), dtype, device),
            "conv_b": _dense((cch,), dtype, device),
            "A_log": _f32((nh,), device),
            "D": _f32((nh,), device),
            "dt_bias": _f32((nh,), device),
            "gnorm": _f32((di,), device),
            "out_proj": _dense((di, d), dtype, device)}


class Layer(nn.Module):
    def __init__(self, cfg, spec: LayerSpec, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.spec = spec
        self.ln1 = _f32((d,), device)
        if spec.mlp == "swiglu":
            self.ln2 = _f32((d,), device)
        mixer = _attn_params if spec.mixer == "attn" else _ssm_params
        self.mixer = nn.ParameterDict(mixer(cfg, dtype, device))
        if spec.mlp == "swiglu":
            self.mlp = nn.ParameterDict({
                "wg": _dense((d, cfg.d_ff), dtype, device),
                "wi": _dense((d, cfg.d_ff), dtype, device),
                "wo": _dense((cfg.d_ff, d), dtype, device)})


class Transformer(nn.Module):
    """Parameters of the stack, allocated uninitialized; ``init_params``
    fills them."""

    def __init__(self, cfg, *, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        _, block, n_blocks = stack_plan(cfg)
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.cfg = cfg
        self.embed = _dense((Vp, d), dtype, device)
        self.final_norm = _f32((d,), device)
        self.head = None if cfg.tie_embeddings else _dense((d, Vp), dtype, device)
        self.layers = nn.ModuleList(Layer(cfg, block[0], dtype, device)
                                    for _ in range(n_blocks))


@torch.no_grad()
def init_params(model: Transformer, seed: int = 0) -> Transformer:
    """Fill ``model`` from a ``torch.Generator`` seeded with ``seed`` on the
    model's device: dense weights normal·1/√fan_in (drawn in f32, then cast),
    norm scales and biases zero, and the SSM leaves as ``init_ssm`` sets
    them: ``A_log = log(linspace(1, 16, nh))``, ``D = 1``, ``dt_bias =
    log(expm1(0.01))``. The random draws are not the JAX package's (tests
    carry JAX weights over with ``repro_torch.convert``)."""
    dev = model.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() < 2:
            p.zero_()
            continue
        w = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev)
        p.copy_(w * (1.0 / math.sqrt(p.shape[-2])))
    for layer in model.layers:
        if layer.spec.mixer == "ssm":
            m = layer.mixer
            nh = m["A_log"].shape[0]
            m["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, nh,
                                                      dtype=torch.float32)))
            m["D"].fill_(1.0)
            m["dt_bias"].copy_(torch.log(torch.expm1(
                torch.full((nh,), 0.01, dtype=torch.float32))))
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def apply_layer(layer: Layer, cfg, x, positions, use_kernels: bool = False):
    """``use_kernels`` routes the mixer through its kernel (``gqa_flash``
    or ``ssd_chunked_kernel``); otherwise the plain paths run."""
    spec = layer.spec
    h = L.rms_norm(x, layer.ln1, cfg.norm_eps)
    if spec.mixer == "attn":
        o = L.attn_forward(layer.mixer, cfg, h, positions, window=spec.window,
                           use_kernel=use_kernels)
    else:
        o = S.ssm_forward(layer.mixer, cfg, h, use_kernel=use_kernels)
    x = x + o
    if spec.mlp == "none":
        return x
    h = L.rms_norm(x, layer.ln2, cfg.norm_eps)
    return x + L.mlp(layer.mlp, h)


def forward(model: Transformer, tokens, *, remat=True, use_kernels=False):
    """tokens (B, S) -> final hidden (B, S, d)."""
    cfg = model.cfg
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = F.embedding(tokens.long(), model.embed)
    for layer in model.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(apply_layer, layer, cfg, x, positions, use_kernels,
                           use_reentrant=False)
        else:
            x = apply_layer(layer, cfg, x, positions, use_kernels)
    return L.rms_norm(x, model.final_norm, cfg.norm_eps)


def head_weight(model: Transformer):
    """The (d, Vp) output projection: a transposed view of the embedding
    when tied (no copy), the ``head`` parameter otherwise."""
    return model.embed.T if model.cfg.tie_embeddings else model.head


def logits_head(model: Transformer, h):
    cfg = model.cfg
    logits = (h @ head_weight(model)).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        col = torch.arange(cfg.padded_vocab, device=h.device)
        logits = torch.where(col < cfg.vocab_size, logits,
                             torch.full_like(logits, -1e30))
    return logits


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def chunked_xent(model: Transformer, h, labels, mask):
    """The ``--kernels reference`` loss. h: (B,S,d); labels/mask: (B,S).
    Returns (sum_nll, sum_mask) in f32."""
    S = h.shape[1]
    c = min(LOSS_CHUNK, S)
    while S % c:                  # largest dividing chunk <= requested
        c -= 1
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        logits = logits_head(model, h[:, sl])                 # (B,c,Vp) f32
        lse = torch.logsumexp(logits, dim=-1)
        col = torch.arange(logits.shape[-1], device=h.device)
        gold = torch.sum(torch.where(col == labels[:, sl, None], logits,
                                     torch.zeros_like(logits)), dim=-1)
        mc = mask[:, sl]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot, cnt


def lm_loss_fn(model: Transformer, batch, *, remat=True, use_kernels=False):
    """Next-token cross-entropy averaged over valid positions.

    Labels are the tokens rolled left by one, the last position masked.
    Returns f32 ``(total_loss, data_loss)``; the dense and ssm families
    have no auxiliary loss, so the two are the same tensor."""
    cfg = model.cfg
    tokens = batch["tokens"]
    h = forward(model, tokens, remat=remat, use_kernels=use_kernels)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).to(torch.int32)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if use_kernels:
        from repro_torch.kernels.fused_xent import fused_xent_sum
        tot, cnt = fused_xent_sum(h, head_weight(model), labels, mask,
                                  cfg.vocab_size)
    else:
        tot, cnt = chunked_xent(model, h, labels, mask)
    loss = (tot / torch.clamp(cnt, min=1.0)).to(torch.float32)
    return loss, loss
