"""Model-facing attention: ``gqa_flash`` with its gradient.

Port of ``repro/kernels/flash_attention/ops.py``. The forward runs the
``flash_attention`` wrapper (the CUDA kernel on the card). The backward
recomputes the plain attention from the saved inputs under autograd and
differentiates it, as the JAX package differentiates ``attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (attention_plain,
                                                        flash_attention)


class _GQAFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = attention_plain(*ins, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, ins, g)
        return dq, dk, dv, None, None


def gqa_flash(q, k, v, *, causal=True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd)."""
    return _GQAFlash.apply(q, k, v, causal, window)
