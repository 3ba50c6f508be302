"""Core transformer layers: RMSNorm, RoPE, the SwiGLU MLP, GQA attention
with an optional sliding window, cross attention (enc-dec) and DeepSeek-V2
multi-head latent attention (MLA).

Port of ``repro.models.layers``: the full-sequence paths, which return
their cache entries on request (``want_cache``), and the one-token decode
paths of serving (``decode_attend``, ``attn_decode``, ``mla_decode``).
Weights keep the JAX layout (``x @ W`` with ``W:
(d_in, d_out)``), so moving weights between the packages is a copy.
Functions take their weights explicitly.

Only GQA self-attention has a kernel (``gqa_flash``). Cross attention and
MLA run ``_attend_chunked`` in either kernel mode, as the JAX package runs
them outside its Pallas kernel; MLA's q/k width (dn + dr) also differs from
its v width, which ``gqa_flash`` does not take. The decode paths run
plain PyTorch under either kernel mode, as the JAX package's serving runs
no Pallas kernel.

Serving keeps its caches in bf16 whatever the compute dtype (the
reference's ``init_cache``), so a decode path may meet an f32 activation
and a bf16 cache entry; ``_mm`` and ``decode_attend`` promote as
``jnp.matmul``/``jnp.einsum`` do (bf16 with f32 is f32), where a torch
product of mixed dtypes would raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import rows_per_chunk

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


def _mm(a, w):
    """``a @ w`` with JAX's dtype promotion."""
    ct = torch.promote_types(a.dtype, w.dtype)
    return a.to(ct) @ w.to(ct)


def gelu(x):
    """GELU, tanh approximation: ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, activation="silu"):
    """Gated MLP: (act(x Wg) ⊙ x Wi) Wo, act SiLU (SwiGLU) or GELU."""
    act = F.silu if activation == "silu" else gelu
    return (act(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def _attend_chunk(qc, k, v, *, causal: bool, window: Optional[int],
                  q0: int):
    """One query chunk of ``_attend_chunked``: qc (B, c, H, hd) at
    position q0 relative to k[0] -> (B, c, K, rep, dv)."""
    B, c, H, hd = qc.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    kpos = torch.arange(Sk, device=qc.device)
    qb = qc.reshape(B, c, K, rep, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qb, k).to(torch.float32) \
        * (1.0 / math.sqrt(hd))
    qpos = q0 + torch.arange(c, device=qc.device)
    mask = torch.ones((c, Sk), dtype=torch.bool, device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", p, v)


def _attend_loop(q, k, v, causal, window, q_offset):
    B, Sq, H, _ = q.shape
    qc = rows_per_chunk(Sq, Q_CHUNK)
    outs = [_attend_chunk(q[:, ci:ci + qc], k, v, causal=causal,
                          window=window, q0=q_offset + ci)
            for ci in range(0, Sq, qc)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, v.shape[-1])


class _ChunkedAttend(torch.autograd.Function):
    """``_attend_chunked`` with a backward that recomputes one query chunk
    at a time: the forward is the same operations, no chunk's scores are
    kept; the backward differentiates each chunk against every key (``dq``
    the chunk's own, ``dk`` and ``dv`` summed in f32 in chunk order and
    cast once), as ``kernels.flash_attention.ops``' backward does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = causal, window, q_offset
        return _attend_loop(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        Sq = q.shape[1]
        qc = rows_per_chunk(Sq, Q_CHUNK)
        f32 = torch.float32
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=f32, device=v.device)
        with torch.enable_grad():
            for q0 in range(0, Sq, qc):
                ins = (q[:, q0:q0 + qc].detach().requires_grad_(True),
                       k.detach().requires_grad_(True),
                       v.detach().requires_grad_(True))
                o = _attend_chunk(*ins, causal=causal, window=window,
                                  q0=q_offset + q0)
                dqc, dkc, dvc = torch.autograd.grad(
                    o, ins, g[:, q0:q0 + qc].reshape(o.shape))
                del o
                dq[:, q0:q0 + qc] = dqc
                dk += dkc
                dv += dvc
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _attend_chunked(q, k, v, *, causal: bool, window: Optional[int],
                    q_offset: int = 0):
    """The ``--kernels reference`` attention path. q: (B, Sq, H, hd);
    k/v: (B, Sk, K, hd) with H = K·rep (v's head dim may differ). Loops
    over query chunks and materializes (B, K, rep, qc, Sk) scores per
    chunk; scores in the input dtype upcast to f32, scaled by 1/√hd,
    probabilities cast back to v.dtype. ``q_offset`` is the position of
    q[0] relative to k[0]. The non-causal use (the encoder and cross
    attention) differentiates through ``_ChunkedAttend``, whose backward
    recomputes one chunk at a time; the causal one (MLA) through autograd,
    which keeps every chunk's scores."""
    if not causal and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _ChunkedAttend.apply(q, k, v, causal, window, q_offset)
    return _attend_loop(q, k, v, causal, window, q_offset)


def attn_forward(p, cfg, x, positions, *, window, use_rope=True,
                 use_kernel=False, want_cache=False, tp=None):
    """Full-sequence causal attention. x: (B, S, d) -> (B, S, d), or with
    ``want_cache`` (out, (k, v)): the keys after RoPE and the values, (B,
    S, K, hd), the layer's cache entry.

    ``use_kernel`` routes the attention core through ``gqa_flash`` (the
    CUDA kernel on the card); otherwise the chunked reference path runs.
    The enc-dec decoder has no RoPE (``use_rope=False``). The head counts
    are the weights' (H = wq's columns / hd): a tensor-parallel rank holds
    its query and KV heads, its input goes through ``tp.copy_in`` and
    its ``wo`` partial sum through ``tp.reduce_out``. Under the head plan's
    KV groups (``launch.shardings``) the weights hold 1–⌈rep/m⌉ query
    heads and one KV head, which is H < num_heads too, even and uneven."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, K = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    split = tp is not None and H < cfg.num_heads
    if split:
        x = tp.copy_in(x)
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
    out = o.reshape(B, S, H * hd) @ p["wo"]
    if split:
        out = tp.reduce_out(out)
    return (out, (k, v)) if want_cache else out


def decode_attend(q, k_cache, v_cache, t, *, window: Optional[int]):
    """One query token against a cache. q: (B, 1, H, hd); caches (B, S,
    K, hd) (v's head dim may differ: MLA); ``t`` the new token's position,
    a Python int (every row at it: the one-shot engine) or a (B,) tensor of
    per-row cursors (continuous-batching slots). Keys at positions > t,
    and with a window those at or before t − window, are masked; scores
    f32, probabilities cast to the cache's dtype, as the reference's."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qr = q.reshape(B, K, rep, hd).to(ct)
    s = torch.einsum("bkrd,bskd->bkrs", qr, k_cache.to(ct)).to(torch.float32)
    s = s * (1.0 / math.sqrt(hd))
    kpos = torch.arange(S, device=q.device)
    tb = t[:, None] if _is_vector(t) else int(t)
    mask = kpos[None, :] <= tb                                   # (B|1, S)
    if window is not None:
        mask = mask & (kpos[None, :] > tb - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache)
    return o.reshape(B, 1, H, v_cache.shape[-1])


def _is_vector(t) -> bool:
    return torch.is_tensor(t) and t.dim() == 1


def _positions(t, device):
    """Decode positions for RoPE: (B, 1) per-row cursors or (1, 1)."""
    if _is_vector(t):
        return t[:, None]
    return torch.full((1, 1), int(t), device=device)


def _write_at(cache, new, t):
    """Write one token's entry ``new`` (B, 1, ...) into ``cache`` (B, S,
    ...) in place: row b at ``t[b]`` for a cursor vector (an indexed
    write, no host read), positions t..t for a scalar. The position must
    lie below S: JAX clamps an index that does not, CUDA faults, so the
    serving engines check it on the host."""
    if _is_vector(t):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, t] = new[:, 0].to(cache.dtype)
    else:
        t = int(t)
        cache[:, t:t + 1] = new.to(cache.dtype)
    return cache


def attn_decode(p, cfg, x, cache_k, cache_v, t, *, window, use_rope=True):
    """One-token decode. x: (B, 1, d); caches (B, S, K, hd), written in
    place at ``t`` (scalar, or a (B,) cursor per row) before the attend.
    -> (out (B, 1, d), cache_k, cache_v)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, K, hd)
    v = (x @ p["wv"]).reshape(B, 1, K, hd)
    if use_rope:
        pos = _positions(t, x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    _write_at(cache_k, k, t)
    _write_at(cache_v, v, t)
    o = decode_attend(q, cache_k, cache_v, t, window=window)
    return _mm(o.reshape(B, 1, H * hd), p["wo"]), cache_k, cache_v


def cross_kv(p, cfg, enc_out):
    """A cross-attention layer's cache entry: the encoder output's keys
    and values (B, Se, K, hd)."""
    B, Se, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return ((enc_out @ p["wk"]).reshape(B, Se, K, hd),
            (enc_out @ p["wv"]).reshape(B, Se, K, hd))


def cross_attn_decode(p, cfg, x, ck, cv):
    """One decoder token against the cached encoder keys and values:
    every encoder position is visible."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    o = decode_attend(q, ck, cv, ck.shape[1] - 1, window=None)
    return _mm(o.reshape(B, 1, H * hd), p["wo"])


def cross_attn_forward(p, cfg, x, enc_kv, tp=None):
    """Cross attention (whisper decoder): queries from x (B, S, d), keys
    and values from the encoder output (B, Se, d); non-causal, no RoPE.
    With ``enc_kv is x`` it is the whisper encoder's self-attention. The
    head counts are the weights' (as in ``attn_forward``): a
    tensor-parallel rank's inputs go through ``tp.copy_in`` (once where
    they are one tensor) and its ``wo`` partial sum through
    ``tp.reduce_out``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, K = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    split = tp is not None and H < cfg.num_heads
    if split:
        same = enc_kv is x
        x = tp.copy_in(x)
        enc_kv = x if same else tp.copy_in(enc_kv)
    Se = enc_kv.shape[1]
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc_kv @ p["wk"]).reshape(B, Se, K, hd)
    v = (enc_kv @ p["wv"]).reshape(B, Se, K, hd)
    o = _attend_chunked(q, k, v, causal=False, window=None)
    out = o.reshape(B, S, H * hd) @ p["wo"]
    return tp.reduce_out(out) if split else out


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
    k_nope = _mm(c_kv, p["wk_b"]).reshape(B, -1, H, dn)
    v = _mm(c_kv, p["wv_b"]).reshape(B, -1, H, dv)
    k_rope_b = k_rope.expand(B, k_nope.shape[1], H, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    o = _attend_chunked(q, k, v, causal=causal, window=None, q_offset=q_offset)
    return o.reshape(B, Sq, H * dv) @ p["wo"]


def mla_forward(p, cfg, x, positions, *, want_cache=False):
    """Full-sequence causal MLA. x: (B, S, d) -> (B, S, d), or with
    ``want_cache`` (out, (c_kv (B, S, r), k_rope (B, S, dr))): the
    compressed cache."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, causal=True)
    return (out, (c_kv, k_rope.squeeze(2))) if want_cache else out


def _mla_attend_decode(p, cfg, q_nope, q_rope, c_kv, k_rope_cache, t):
    """One-token MLA with per-row cursors ``t`` (B,): the latent cache
    expanded as in ``_mla_attend``, then ``decode_attend`` with K = H
    (the chunked path's scalar ``q_offset`` cannot take a vector)."""
    B, _, H, dn = q_nope.shape
    dv = cfg.v_head_dim
    k_nope = _mm(c_kv, p["wk_b"]).reshape(B, -1, H, dn)
    v = _mm(c_kv, p["wv_b"]).reshape(B, -1, H, dv)
    k_rope_b = k_rope_cache[:, :, None, :].expand(B, k_nope.shape[1], H,
                                                  k_rope_cache.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    o = decode_attend(q, k, v, t, window=None)
    return _mm(o.reshape(B, 1, H * dv), p["wo"])


def mla_decode(p, cfg, x, cache_ckv, cache_krope, t):
    """One-token MLA. cache_ckv (B, S, r) and cache_krope (B, S, dr), the
    compressed cache, written in place at ``t`` (scalar or (B,) cursors).
    A scalar ``t`` attends through ``_mla_attend(q_offset=t)`` over the
    whole cache (positions past t masked as causal), a vector through
    ``_mla_attend_decode``. -> (out, cache_ckv, cache_krope)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, _positions(t, x.device))
    _write_at(cache_ckv, c_kv, t)
    _write_at(cache_krope, k_rope[:, :, 0], t)
    if _is_vector(t):
        out = _mla_attend_decode(p, cfg, q_nope, q_rope, cache_ckv,
                                 cache_krope, t)
    else:
        out = _mla_attend(p, cfg, q_nope, q_rope, cache_ckv,
                          cache_krope[:, :, None, :], causal=True,
                          q_offset=int(t))
    return out, cache_ckv, cache_krope
