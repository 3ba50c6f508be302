"""Model-facing fused cross-entropy: ``fused_xent_sum`` with its gradient.

Port of ``repro/kernels/fused_xent/ops.py``. The forward runs the
``fused_xent`` wrapper (the CUDA kernel on the card); the masked sum and
count stay here, as in the JAX package. The backward is the analytic
softmax gradient (p − onehot) in torch, in sequence chunks of at most 512,
as the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_xent.kernel import fused_xent


def _sum_value(h, w, labels, mask, vocab_size):
    B, S, d = h.shape
    N = B * S
    nll = fused_xent(h.reshape(N, d), w, labels.reshape(N), vocab_size)
    m = mask.reshape(N).to(torch.float32)
    return torch.sum(nll * m), torch.sum(m)


class _FusedXentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, mask, vocab_size):
        ctx.save_for_backward(h, w, labels, mask)
        ctx.vocab_size = vocab_size
        tot, cnt = _sum_value(h, w, labels, mask, vocab_size)
        ctx.mark_non_differentiable(cnt)
        return tot, cnt

    @staticmethod
    def backward(ctx, g_tot, _g_cnt):
        h, w, labels, mask = ctx.saved_tensors
        B, S, d = h.shape
        Vp = w.shape[1]
        c = S
        while c > 512 and c % 2 == 0:
            c //= 2
        w32 = w.to(torch.float32)
        col = torch.arange(Vp, device=h.device)
        dw = torch.zeros((d, Vp), dtype=torch.float32, device=h.device)
        dh = torch.empty_like(h)
        for i in range(S // c):
            sl = slice(i * c, (i + 1) * c)
            hs = h[:, sl].to(torch.float32)
            logits = hs @ w32
            if ctx.vocab_size != Vp:
                logits = torch.where(col < ctx.vocab_size, logits,
                                     torch.full_like(logits, -1e30))
            delta = torch.softmax(logits, dim=-1)
            del logits
            # p - onehot, without materializing the one-hot tensor
            delta.scatter_add_(-1, labels[:, sl].long()[..., None],
                               torch.full((B, c, 1), -1.0, device=h.device))
            delta *= (mask[:, sl].to(torch.float32) * g_tot)[..., None]
            dh[:, sl] = (delta @ w32.T).to(h.dtype)
            dw += torch.einsum("bsd,bsv->dv", hs, delta)
        return dh, dw.to(w.dtype), None, None, None


def fused_xent_sum(h, w, labels, mask, vocab_size: int):
    """h: (B,S,d); w: (d,Vp); labels/mask: (B,S) -> (sum_nll, sum_mask),
    both f32; differentiable in h and w."""
    return _FusedXentSum.apply(h, w, labels, mask, vocab_size)
