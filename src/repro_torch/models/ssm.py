"""Mamba2 mixer, SSD (state-space duality) form [arXiv:2405.21060].

Port of ``repro.models.ssm``: the within-chunk computation as
decay-masked block products, the cross-chunk recurrence as a loop over the
``S/chunk`` chunk states, and serving's one-token recurrent update
(``ssm_decode``). A prefill's cache entry is ``(conv_state, ssd_state)``:
the last ``conv_width − 1`` rows of ``xBC`` before the convolution and
the final SSD state.

One deliberate difference from the reference's ``_segsum``: the decay
matrix (in ``ssd_intra_chunk_plain``, which ``ssd_chunked`` calls) is
``exp(where(i ≥ j, cum_i − cum_j, −inf))`` rather than
``where(i ≥ j, exp(cum_i − cum_j), 0)``. The values are the same; the
reference's gradient is NaN once an upper-triangle exponent overflows
(0·inf), this one stays finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_chunked_kernel, ssd_intra_chunk_plain
from repro_torch.kernels.ssd_scan.ops import chunk_len, chunk_recurrence
from repro_torch.models.layers import rms_norm


def conv_channels(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def _split_proj(cfg, zxbcdt):
    di, gs = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * gs]
    dt = zxbcdt[..., 2 * di + 2 * gs:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width cw. xBC: (B, S, C); w: (cw, C). The
    reference's sum of shifted products in the input dtype, left to right
    (not ``F.conv1d``), so bf16 rounds as it does there."""
    cw, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, cw - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(cw))
    return F.silu(out + b)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward over chunks, the plain path.

    x: (b, S, nh, hd); dt: (b, S, nh) (post-softplus); A: (nh,) negative;
    B, C: (b, S, G, ds). Returns (y: (b, S, nh, hd), final_state:
    (b, nh, hd, ds)), both f32. The within-chunk terms are the kernel's
    plain version on the chunked views; the recurrence and ``Y_off``
    follow the reference with B and C repeated to every head.
    """
    b, S, nh, hd = x.shape
    G, ds = B.shape[-2], B.shape[-1]
    cl = chunk_len(S, chunk)
    nc = S // cl

    y_diag, states, decays = ssd_intra_chunk_plain(
        x.reshape(b * nc, cl, nh, hd), dt.reshape(b * nc, cl, nh), A,
        B.reshape(b * nc, cl, G, ds), C.reshape(b * nc, cl, G, ds))

    # inter-chunk recurrence: prevs[:, n] is the state BEFORE chunk n
    prevs, state = chunk_recurrence(states.reshape(b, nc, nh, hd, ds),
                                    decays.reshape(b, nc, nh))

    Ch = C.repeat_interleave(nh // G, dim=-2).reshape(b, nc, cl, nh, ds).to(torch.float32)
    cum = torch.cumsum((dt * A).reshape(b, nc, cl, nh), dim=2)
    Y_off = torch.einsum("bnihd,bnhpd,bnih->bnihp", Ch, prevs, torch.exp(cum))
    y = (y_diag.reshape(b, nc, cl, nh, hd) + Y_off).reshape(b, S, nh, hd)
    return y, state


def ssm_forward(p, cfg, x, *, use_kernel: bool = False,
                want_cache: bool = False):
    """Full-sequence Mamba2 mixer. x: (B, S, d) -> (B, S, d), or with
    ``want_cache`` (out, (conv_state (B, cw − 1, C), ssd_state (B, nh, hd,
    ds) f32)).

    ``use_kernel`` routes the SSD core through ``ssd_chunked_kernel`` (the
    CUDA kernel on the card); otherwise the plain ``ssd_chunked`` runs."""
    b, S, _ = x.shape
    di, nh, hd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    G, ds = cfg.ssm_ngroups, cfg.ssm_state
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])
    tail = xBC[:, -(cfg.conv_width - 1):, :] if want_cache else None
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(b, S, nh, hd)
    Bm = xBC[..., di:di + G * ds].reshape(b, S, G, ds)
    Cm = xBC[..., di + G * ds:].reshape(b, S, G, ds)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ssd = ssd_chunked_kernel if use_kernel else ssd_chunked
    y, ssd_state = ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = y + p["D"][:, None] * xs.to(torch.float32)
    y = y.reshape(b, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return (out, (tail, ssd_state)) if want_cache else out


def ssm_decode(p, cfg, x, conv_state, ssd_state):
    """One-token recurrent update. x: (B, 1, d); conv_state (B, cw − 1,
    C); ssd_state (B, nh, hd, ds) f32. -> (out (B, 1, d), new conv_state,
    new ssd_state), new tensors. The conv window is the cached rows and
    the new one, promoted as ``jnp.concatenate`` promotes (a bf16 cache
    with an f32 model gives an f32 state)."""
    b = x.shape[0]
    di, nh, hd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    G, ds = cfg.ssm_ngroups, cfg.ssm_state
    z, xBC, dt = _split_proj(cfg, x @ p["in_proj"])             # (B, 1, *)
    window = torch.cat([conv_state, xBC], dim=1)                # (B, cw, C)
    ct = torch.promote_types(window.dtype, p["conv_w"].dtype)
    out = (torch.einsum("bwc,wc->bc", window.to(ct), p["conv_w"].to(ct))
           + p["conv_b"])
    xBC = F.silu(out)[:, None, :]
    xs = xBC[..., :di].reshape(b, nh, hd)
    Bm = xBC[..., di:di + G * ds].reshape(b, G, ds).repeat_interleave(nh // G, 1)
    Cm = xBC[..., di + G * ds:].reshape(b, G, ds).repeat_interleave(nh // G, 1)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt1 * A)
    xdt = xs.to(torch.float32) * dt1[..., None]                 # (B, nh, hd)
    state = (ssd_state * decay[..., None, None]
             + torch.einsum("bhp,bhd->bhpd", xdt, Bm.to(torch.float32)))
    y = torch.einsum("bhpd,bhd->bhp", state, Cm.to(torch.float32))
    y = y + p["D"][:, None] * xs.to(torch.float32)
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"], window[:, 1:, :], state
