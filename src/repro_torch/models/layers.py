"""Core transformer layers for the dense family: RMSNorm, RoPE, SwiGLU MLP
and GQA attention with an optional sliding window.

Port of the dense part of ``repro.models.layers``. Weights keep the JAX
layout (``x @ W`` with ``W: (d_in, d_out)``), so moving weights between the
packages is a copy. Functions take their weights explicitly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Q_CHUNK = 512                        # query rows per chunk of the reference path


def rms_norm(x, scale, eps=1e-5):
    """x·rsqrt(mean x² + eps)·(1 + scale), computed in f32."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of head_dim (split halves, not interleaved pairs)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                        # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * inv        # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp(p, x):
    """SwiGLU: (silu(x Wg) ⊙ x Wi) Wo."""
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int]):
    """The ``--kernels reference`` attention path. q: (B, Sq, H, hd);
    k/v: (B, Sk, K, hd) with H = K·rep. Loops over query chunks and
    materializes (B, K, rep, qc, Sk) scores per chunk; scores in the input
    dtype upcast to f32, probabilities cast back to v.dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    qc = min(Q_CHUNK, Sq)
    while Sq % qc:                   # largest divisor of Sq <= Q_CHUNK
        qc -= 1
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for ci in range(Sq // qc):
        qb = q[:, ci * qc:(ci + 1) * qc].reshape(B, qc, K, rep, hd)
        s = torch.einsum("bqkrd,bskd->bkrqs", qb, k).to(torch.float32) * scale
        qpos = ci * qc + torch.arange(qc, device=q.device)
        mask = torch.ones((qc, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkrqs,bskd->bqkrd", p, v))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, v.shape[-1])


def attn_forward(p, cfg, x, positions, *, window, use_kernel=False):
    """Full-sequence causal attention. x: (B, S, d) -> (B, S, d).

    ``use_kernel`` routes the attention core through ``gqa_flash`` (the
    CUDA kernel on the card); otherwise the chunked reference path runs."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernel:
        from repro_torch.kernels.flash_attention import gqa_flash
        o = gqa_flash(q, k, v, causal=True, window=window)
    else:
        o = _attend_chunked(q, k, v, causal=True, window=window)
    return o.reshape(B, S, H * hd) @ p["wo"]
