"""Model-facing attention: ``gqa_flash`` with its gradient.

Port of ``repro/kernels/flash_attention/ops.py``. The forward runs the
``flash_attention`` wrapper (the CUDA kernel on the card). The backward
recomputes the plain attention from the saved inputs under autograd and
differentiates it, as the JAX package differentiates ``attention_ref``,
one query chunk at a time: ``Q_CHUNK`` rows (the reference's
``DEFAULT_Q_CHUNK``), or the largest divisor of Sq at or below it, as the
reference's ``_attend_chunked`` tiles its queries. A chunk reads only the
keys its rows can see (``key_range``: up to its last row when causal, from
its first row's window start), so its scores are (B, H, chunk, keys seen),
never S × S. The masked keys it leaves out contribute exactly 0 to every
value, so the trim changes none. ``dq`` is each chunk's own; ``dk`` and
``dv`` are summed in f32 over the chunks, in chunk order, and cast once.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (attention_plain,
                                                        flash_attention)

Q_CHUNK = 512         # the reference's DEFAULT_Q_CHUNK (models/layers.py)


def rows_per_chunk(Sq: int, chunk: int) -> int:
    """Rows a chunk: ``chunk``, or the largest divisor of Sq below it."""
    qc = min(chunk, Sq)
    while Sq % qc:
        qc -= 1
    return qc


def key_range(q0: int, q1: int, Sk: int, causal: bool,
              window: Optional[int]) -> tuple:
    """Keys ``[lo, hi)`` that query rows ``[q0, q1)`` can see. A row that
    sees no key at all softmaxes over every key (all scores -1e30), so a
    chunk holding such a row keeps them all."""
    def seen(q):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = min(Sk, q + 1) if causal else Sk
        return lo, hi

    (lo, first_hi), (last_lo, hi) = seen(q0), seen(q1 - 1)
    if lo >= first_hi or last_lo >= hi:
        return 0, Sk
    return lo, hi


class _GQAFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        Sq, Sk = q.shape[1], k.shape[1]
        qc = rows_per_chunk(Sq, Q_CHUNK)
        f32 = torch.float32
        kf, vf = k.detach().to(f32), v.detach().to(f32)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=f32, device=v.device)
        with torch.enable_grad():
            for q0 in range(0, Sq, qc):
                lo, hi = key_range(q0, q0 + qc, Sk, ctx.causal, ctx.window)
                ins = (q[:, q0:q0 + qc].detach().requires_grad_(True),
                       kf[:, lo:hi].detach().requires_grad_(True),
                       vf[:, lo:hi].detach().requires_grad_(True))
                o = attention_plain(*ins, causal=ctx.causal,
                                    window=ctx.window, q_offset=q0 - lo)
                dqc, dkc, dvc = torch.autograd.grad(o, ins,
                                                    g[:, q0:q0 + qc])
                del o
                dq[:, q0:q0 + qc] = dqc
                dk[:, lo:hi] += dkc
                dv[:, lo:hi] += dvc
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


def gqa_flash(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd)."""
    return _GQAFlash.apply(q, k, v, causal, window)
