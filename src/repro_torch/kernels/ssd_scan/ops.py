"""Model-facing SSD: ``ssd_chunked_kernel`` with its gradient.

Port of ``repro/kernels/ssd_scan/ops.py::ssd_chunked_pallas``, with the
contract of ``models.ssm.ssd_chunked``. The forward runs the
``ssd_intra_chunk`` wrapper (the CUDA kernel on the card) on the chunked
views of the inputs, then the inter-chunk recurrence over the ``nc`` chunk
states and the off-diagonal term ``Y_off`` in torch, as the JAX wrapper
runs them in jnp. B and C stay in their group layout throughout. The
backward differentiates the plain ``ssd_chunked`` on the saved inputs, as
``_ssd_bwd`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk


def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk``."""
    cl = min(chunk, S)
    while S % cl:
        cl -= 1
    return cl


def chunk_recurrence(states, decays):
    """states: (b, nc, nh, hd, ds); decays: (b, nc, nh), f32. -> (the state
    BEFORE each chunk (b, nc, nh, hd, ds), the final state (b, nh, hd, ds)),
    from a zero initial state: state = state · decay_n + states_n."""
    state = torch.zeros_like(states[:, 0])
    prevs = []
    for n in range(states.shape[1]):
        prevs.append(state)
        state = state * decays[:, n, :, None, None] + states[:, n]
    return torch.stack(prevs, dim=1), state


def _forward(x, dt, A, B, C, chunk):
    b, S, nh, hd = x.shape
    G, ds = B.shape[-2], B.shape[-1]
    cl = chunk_len(S, chunk)
    nc, rep = S // cl, nh // G
    dtr = dt.reshape(b * nc, cl, nh)
    Cr = C.reshape(b * nc, cl, G, ds)
    y_diag, states, decays = ssd_intra_chunk(
        x.reshape(b * nc, cl, nh, hd), dtr, A, B.reshape(b * nc, cl, G, ds), Cr)
    prevs, state = chunk_recurrence(states.reshape(b, nc, nh, hd, ds),
                                    decays.reshape(b, nc, nh))
    prevs = prevs.reshape(b, nc, G, rep, hd, ds)

    # off-diagonal: Y_off[i] = C_i · prev_state · exp(cum_i)
    cum = torch.cumsum((dtr * A).reshape(b, nc, cl, nh), dim=2)
    y_off = torch.einsum("bnigd,bngrpd->bnigrp",
                         Cr.reshape(b, nc, cl, G, ds).to(torch.float32), prevs)
    y_off = y_off.reshape(b, nc, cl, nh, hd) * torch.exp(cum)[..., None]
    y = (y_diag.reshape(b, nc, cl, nh, hd) + y_off).reshape(b, S, nh, hd)
    return y, state


class _SSDChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.models.ssm import ssd_chunked
        saved = ctx.saved_tensors
        want = [i for i in range(5) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(i in want)
                   for i, t in enumerate(saved)]
            y, state = ssd_chunked(*ins, chunk=ctx.chunk)
            outs = [(o, g) for o, g in ((y, gy), (state, gstate))
                    if g is not None]
            grads = torch.autograd.grad([o for o, _ in outs], [ins[i] for i in want],
                                        [g for _, g in outs])
        full = [None] * 5
        for i, g in zip(want, grads):
            full[i] = g
        return (*full, None)


def ssd_chunked_kernel(x, dt, A, B, C, *, chunk: int):
    """x: (b, S, nh, hd); dt: (b, S, nh) f32 (post-softplus); A: (nh,) f32
    negative; B/C: (b, S, G, ds). -> (y (b, S, nh, hd) f32, final_state
    (b, nh, hd, ds) f32)."""
    return _SSDChunked.apply(x, dt, A, B, C, chunk)
