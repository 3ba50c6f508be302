"""Port vs JAX: the attention backward in query chunks.

``gqa_flash``'s backward recomputes and differentiates the plain attention
one query chunk at a time, each chunk against the keys its rows can see
(``repro_torch.kernels.flash_attention.ops``). The inputs are drawn from
a seed with numpy and go through JAX's ``jax.vjp`` of
``repro.kernels.flash_attention.ops.gqa_flash`` (the Pallas forward in
interpret mode, the backward the VJP of ``attention_ref``, as the JAX
package's own tests run it) and through the port's backward at chunk 16,
so that S = 64 makes four chunks and the causal and window trims cut keys
from both ends. Causal, sliding-window (20, not a multiple of the chunk)
and non-causal, at H/K = 2 and 4 and hd 64 and 256.

Tolerances, f32 inputs, each over ``max|ref|`` of its gradient:

  * against JAX's VJP, ``dq``, ``dk`` and ``dv`` alike: the shared
    ``TOLERANCES["flash_attention"]["float32"]`` (2e-5, 2e-5), as the
    whole-sequence backward is held (``test_torch_kernels.py``);
  * against the port's whole-sequence backward (one chunk of S rows):
    ``dq`` 1e-6 (each row's gradient is its own chunk's: the same
    products over the same live keys); ``dk`` and ``dv`` 1e-5 (the
    chunks' sums added in f32 in chunk order: association only).

In bf16 ``dq`` and the chunk sums are f32 until one cast, as in the
whole-sequence backward, so the two differ by at most one bf16 rounding
of that last cast: 2⁻⁷·max|ref|.

The meta-device count (``analysis.count.CostCount``) of the backward at
S = 4·chunk holds a smaller temporary peak than the whole-sequence
backward's, and fewer FLOPs under the causal mask (the trimmed keys).
"""
import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_flash as j_gqa_flash
from repro_torch.analysis.count import CostCount
from repro_torch.kernels.flash_attention import gqa_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (Q_CHUNK, key_range,
                                                     rows_per_chunk)
from repro_torch.kernels.numerics import TOLERANCES

torch.set_num_threads(2)
AT = TOLERANCES["flash_attention"]["float32"]
B, S, K, CHUNK = 2, 64, 2, 16
MASKS = {"causal": (True, None), "window": (True, 20),
         "noncausal": (False, None)}
CASES = list(itertools.product(MASKS, (2, 4), (64, 256)))
IDS = [f"{m}-rep{r}-hd{hd}" for m, r, hd in CASES]


def _inputs(rep, hd, seed):
    rng = np.random.RandomState(seed)
    H = K * rep
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, K, hd).astype(np.float32)
    v = rng.randn(B, S, K, hd).astype(np.float32)
    g = rng.randn(B, S, H, hd).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, causal, window, chunk, dtype=torch.float32):
    """The port's gradients with the backward at ``chunk`` rows a chunk
    (``ops.Q_CHUNK``, restored after)."""
    ins = [torch.from_numpy(a).to(dtype).requires_grad_(True)
           for a in (q, k, v)]
    out = gqa_flash(*ins, causal=causal, window=window)
    with _chunk(chunk):
        return torch.autograd.grad(out, ins, torch.from_numpy(g).to(dtype))


@contextlib.contextmanager
def _chunk(n):
    """``with _chunk(n):`` the backward takes n query rows a chunk."""
    saved, ops.Q_CHUNK = ops.Q_CHUNK, n
    try:
        yield
    finally:
        ops.Q_CHUNK = saved


def _within(port, ref, rtol_of_max, what):
    ref = np.asarray(ref, np.float32)
    port = np.asarray(port, np.float32)
    bound = rtol_of_max * float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    assert err <= bound, f"{what}: max |Δ| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("mask,rep,hd", CASES, ids=IDS)
def test_chunked_backward_matches_jax_vjp(mask, rep, hd):
    causal, window = MASKS[mask]
    q, k, v, g = _inputs(rep, hd, seed=rep * 1000 + hd)
    _, vjp = jax.vjp(lambda q_, k_, v_: j_gqa_flash(
        q_, k_, v_, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, g, causal, window, CHUNK)
    rtol, atol = AT
    for name, port, ref in zip(("dq", "dk", "dv"), got, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            port.numpy(), ref, rtol=rtol,
            atol=atol * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("mask,rep,hd", CASES, ids=IDS)
def test_chunked_backward_matches_the_whole_sequence_backward(mask, rep, hd):
    causal, window = MASKS[mask]
    q, k, v, g = _inputs(rep, hd, seed=rep * 1000 + hd + 1)
    got = _port_grads(q, k, v, g, causal, window, CHUNK)
    whole = _port_grads(q, k, v, g, causal, window, S)
    for name, a, b, tol in zip(("dq", "dk", "dv"), got, whole,
                               (1e-6, 1e-5, 1e-5)):
        _within(a.numpy(), b.numpy(), tol, name)


@pytest.mark.parametrize("mask", list(MASKS))
def test_chunked_backward_in_bf16_is_one_rounding_from_the_whole(mask):
    causal, window = MASKS[mask]
    q, k, v, g = _inputs(2, 64, seed=5)
    got = _port_grads(q, k, v, g, causal, window, CHUNK, torch.bfloat16)
    whole = _port_grads(q, k, v, g, causal, window, S, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, whole):
        assert a.dtype == torch.bfloat16
        _within(a.float().numpy(), b.float().numpy(), 2.0 ** -7, name)


def test_rows_per_chunk_is_the_largest_divisor_at_or_below_the_chunk():
    assert Q_CHUNK == 512
    assert rows_per_chunk(4096, Q_CHUNK) == 512
    assert rows_per_chunk(1024, Q_CHUNK) == 512
    assert rows_per_chunk(100, Q_CHUNK) == 100
    assert rows_per_chunk(1500, Q_CHUNK) == 500
    assert rows_per_chunk(64, 16) == 16
    assert rows_per_chunk(1031, Q_CHUNK) == 1   # a prime: one row a chunk


@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None), (False, 20)])
def test_key_range_covers_every_live_key_of_the_chunk(causal, window):
    Sk = 64
    kpos = np.arange(Sk)
    for q0 in range(0, 64, 16):
        lo, hi = key_range(q0, q0 + 16, Sk, causal, window)
        live = np.zeros(Sk, bool)
        for q in range(q0, q0 + 16):
            m = np.ones(Sk, bool)
            if causal:
                m &= kpos <= q
            if window is not None:
                m &= kpos > q - window
            live |= m
        assert live[lo:hi].all() and not live[:lo].any() \
            and not live[hi:].any(), (q0, lo, hi)
    # a row that sees no key (non-causal, past the keys' window) keeps all
    assert key_range(90, 100, Sk, False, 10) == (0, Sk)


def _meta_count(chunk, causal=True, S_=4 * CHUNK, hd=64):
    q = torch.empty(B, S_, K * 2, hd, device="meta", requires_grad=True)
    k = torch.empty(B, S_, K, hd, device="meta", requires_grad=True)
    v = torch.empty(B, S_, K, hd, device="meta", requires_grad=True)
    g = torch.empty(B, S_, K * 2, hd, device="meta")
    out = gqa_flash(q, k, v, causal=causal, window=None)
    with _chunk(chunk), CostCount() as cc:
        torch.autograd.grad(out, (q, k, v), g)
    return cc.count


def test_chunked_backward_holds_a_smaller_temporary_peak():
    chunked, whole = _meta_count(CHUNK), _meta_count(4 * CHUNK)
    assert 0 < chunked.temp_peak < whole.temp_peak
    # the causal trim: the chunks read 1, 2, 3, 4 chunks of keys, so the
    # recomputed scores' products are 10/16 of the whole backward's
    assert chunked.flops < whole.flops
    nc_chunked, nc_whole = (_meta_count(CHUNK, causal=False),
                            _meta_count(4 * CHUNK, causal=False))
    assert nc_chunked.flops == nc_whole.flops
    assert nc_chunked.temp_peak < nc_whole.temp_peak
