"""Core transformer layers: RMSNorm, RoPE, the SwiGLU MLP, GQA attention
with an optional sliding window, cross attention (enc-dec) and DeepSeek-V2
multi-head latent attention (MLA).

Port of the training half of ``repro.models.layers`` (the decode halves
come with serving). Weights keep the JAX layout (``x @ W`` with ``W:
(d_in, d_out)``), so moving weights between the packages is a copy.
Functions take their weights explicitly.

Only GQA self-attention has a kernel (``gqa_flash``). Cross attention and
MLA run ``_attend_chunked`` in either kernel mode, as the JAX package runs
them outside its Pallas kernel; MLA's q/k width (dn + dr) also differs from
its v width, which ``gqa_flash`` does not take.
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


def gelu(x):
    """GELU, tanh approximation: ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, activation="silu"):
    """Gated MLP: (act(x Wg) ⊙ x Wi) Wo, act SiLU (SwiGLU) or GELU."""
    act = F.silu if activation == "silu" else gelu
    return (act(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int],
                    q_offset: int = 0):
    """The ``--kernels reference`` attention path. q: (B, Sq, H, hd);
    k/v: (B, Sk, K, hd) with H = K·rep (v's head dim may differ). Loops
    over query chunks and materializes (B, K, rep, qc, Sk) scores per
    chunk; scores in the input dtype upcast to f32, scaled by 1/√hd,
    probabilities cast back to v.dtype. ``q_offset`` is the position of
    q[0] relative to k[0]."""
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
        qpos = q_offset + ci * qc + torch.arange(qc, device=q.device)
        mask = torch.ones((qc, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkrqs,bskd->bqkrd", p, v))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, v.shape[-1])


def attn_forward(p, cfg, x, positions, *, window, use_rope=True,
                 use_kernel=False):
    """Full-sequence causal attention. x: (B, S, d) -> (B, S, d).

    ``use_kernel`` routes the attention core through ``gqa_flash`` (the
    CUDA kernel on the card); otherwise the chunked reference path runs.
    The enc-dec decoder has no RoPE (``use_rope=False``)."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if use_kernel:
        from repro_torch.kernels.flash_attention import gqa_flash
        o = gqa_flash(q, k, v, causal=True, window=window)
    else:
        o = _attend_chunked(q, k, v, causal=True, window=window)
    return o.reshape(B, S, H * hd) @ p["wo"]


def cross_attn_forward(p, cfg, x, enc_kv):
    """Cross attention (whisper decoder): queries from x (B, S, d), keys
    and values from the encoder output (B, Se, d); non-causal, no RoPE."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Se = enc_kv.shape[1]
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc_kv @ p["wk"]).reshape(B, Se, K, hd)
    v = (enc_kv @ p["wv"]).reshape(B, Se, K, hd)
    o = _attend_chunked(q, k, v, causal=False, window=None)
    return o.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def _mla_qkv(p, cfg, x, positions):
    """-> q_nope (B,S,H,dn), q_rope (B,S,H,dr), the RMS-normed latent c_kv
    (B,S,r) and k_rope (B,S,1,dr), one rope key shared by every head."""
    B, S, _ = x.shape
    H = cfg.num_heads
    r, dr, dn = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                                         # (B, S, r + dr)
    c_kv = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, r:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, *, causal, q_offset=0):
    """Expands the latent into per-head keys and values and attends: the
    softmax scale is 1/√(dn + dr), the output width H·dv."""
    B, Sq, H, dn = q_nope.shape
    dv = cfg.v_head_dim
    k_nope = (c_kv @ p["wk_b"]).reshape(B, -1, H, dn)
    v = (c_kv @ p["wv_b"]).reshape(B, -1, H, dv)
    k_rope_b = k_rope.expand(B, k_nope.shape[1], H, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    o = _attend_chunked(q, k, v, causal=causal, window=None, q_offset=q_offset)
    return o.reshape(B, Sq, H * dv) @ p["wo"]


def mla_forward(p, cfg, x, positions):
    """Full-sequence causal MLA. x: (B, S, d) -> (B, S, d)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    return _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, causal=True)
