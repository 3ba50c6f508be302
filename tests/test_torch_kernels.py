"""Port vs JAX: the kernels' plain versions and their gradients.

On the CPU each port wrapper computes its plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode, as the JAX package's own
tests run them. Tolerances are the shared ``TOLERANCES[kernel]["float32"]``.
The kernels themselves run only on the card: ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_flash as j_gqa_flash
from repro.kernels.fused_xent import fused_xent as j_fused_xent
from repro.kernels.fused_xent.ops import fused_xent_sum as j_fused_xent_sum
from repro.kernels import numerics as J_numerics
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention, gqa_flash)
from repro_torch.kernels.flash_attention import kernel as attn_kernel
from repro_torch.kernels.fused_xent import (fused_xent, fused_xent_sum,
                                            xent_plain)
from repro_torch.kernels.fused_xent import kernel as xent_kernel
from repro_torch.kernels.numerics import (ATTN_SHAPES, SSD_SHAPES, TOLERANCES,
                                          XENT_SHAPES, gqa_split)

torch.set_num_threads(2)
XT = TOLERANCES["fused_xent"]["float32"]
AT = TOLERANCES["flash_attention"]["float32"]


def _xent_inputs(N, d, Vp, V, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, d).astype(np.float32)
    w = (rng.randn(d, Vp) * 0.05).astype(np.float32)
    y = rng.randint(0, V, size=N).astype(np.int32)
    return h, w, y


def _attn_inputs(BH, S, hd, seed=0):
    B, H, K = gqa_split(BH)
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, K, hd).astype(np.float32)
    v = rng.randn(B, S, K, hd).astype(np.float32)
    return q, k, v


def _close(port, ref, tol, scale=1.0):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol * scale)


def test_tolerances_equal_jax():
    """The port's copies of the tolerance table and the shape grids."""
    assert TOLERANCES == J_numerics.TOLERANCES
    assert XENT_SHAPES == J_numerics.XENT_SHAPES
    assert ATTN_SHAPES == J_numerics.ATTN_SHAPES
    assert SSD_SHAPES == J_numerics.SSD_SHAPES


@pytest.mark.parametrize("shape", XENT_SHAPES, ids=str)
def test_xent_plain_matches_jax(shape):
    N, d, Vp, V = shape
    h, w, y = _xent_inputs(*shape)
    ref = j_fused_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                       vocab_size=V, interpret=True)
    out = fused_xent(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(y), V)
    assert out.dtype == torch.float32 and out.shape == (N,)
    _close(out.numpy(), ref, XT)
    _close(xent_plain(torch.from_numpy(h), torch.from_numpy(w),
                      torch.from_numpy(y), V).numpy(), ref, XT)


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_plain_matches_jax(shape):
    BH, S, hd, causal, window = shape
    q, k, v = _attn_inputs(BH, S, hd)
    ref = j_gqa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = gqa_flash(tq, tk, tv, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == torch.float32
    _close(out.numpy(), ref, AT)
    _close(attention_plain(tq, tk, tv, causal=causal, window=window).numpy(),
           ref, AT)


@pytest.mark.parametrize("B,S,d,Vp,V,tied", [
    (2, 64, 32, 512, 500, False),    # padded vocab
    (3, 40, 48, 256, 256, True),     # w = embed.T, a transposed view
    (1, 1024, 16, 128, 128, False),  # S > 512: the backward's chunk loop
])
def test_xent_grads_match_jax(B, S, d, Vp, V, tied):
    rng = np.random.RandomState(1)
    h = rng.randn(B, S, d).astype(np.float32)
    w = (rng.randn(d, Vp) * 0.05).astype(np.float32)
    y = rng.randint(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.rand(B, S) < 0.8).astype(np.float32)

    def jloss(h_, w_):
        tot, cnt = j_fused_xent_sum(h_, w_, jnp.asarray(y), jnp.asarray(mask), V)
        return tot / cnt

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))

    th = torch.from_numpy(h).requires_grad_(True)
    if tied:
        emb = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
        tw = emb.T
    else:
        emb = tw = torch.from_numpy(w).requires_grad_(True)
    tot, cnt = fused_xent_sum(th, tw, torch.from_numpy(y),
                              torch.from_numpy(mask), V)
    loss = tot / cnt
    dh, demb = torch.autograd.grad(loss, (th, emb))
    dw = demb.T if tied else demb
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for port, ref in ((dh, jdh), (dw, jdw)):
        scale = float(np.abs(np.asarray(ref)).max())
        _close(port.numpy(), ref, XT, scale)


@pytest.mark.parametrize("shape", [ATTN_SHAPES[1], ATTN_SHAPES[2],
                                   ATTN_SHAPES[3], ATTN_SHAPES[4]], ids=str)
def test_attention_grads_match_jax(shape):
    BH, S, hd, causal, window = shape
    q, k, v = _attn_inputs(BH, S, hd, seed=2)
    r = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(j_gqa_flash(q_, k_, v_, causal=causal, window=window) * r)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = gqa_flash(*ins, causal=causal, window=window)
    tg = torch.autograd.grad((out * torch.from_numpy(r)).sum(), ins)
    for port, ref in zip(tg, jg):
        scale = float(np.abs(np.asarray(ref)).max())
        _close(port.numpy(), ref, AT, scale)


def test_wrappers_check_their_inputs():
    h, w, y = map(torch.from_numpy, _xent_inputs(16, 8, 256, 256))
    with pytest.raises(TypeError):
        fused_xent(h, w, y.long(), 256)                 # int64 labels
    with pytest.raises(TypeError):
        fused_xent(h, w.double(), y, 256)
    with pytest.raises(ValueError):
        fused_xent(h, w[:4], y, 256)                    # d mismatch
    with pytest.raises(ValueError):
        fused_xent(h, w, y, 300)                        # vocab > Vp
    with pytest.raises(ValueError):
        fused_xent(h.to("meta"), w.to("meta"), y.to("meta"), 256)
    q, k, v = map(torch.from_numpy, _attn_inputs(8, 64, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q[..., :8], k[..., :8], v[..., :8])   # head_dim 8
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert fused_xent.launches == 0 and flash_attention.launches == 0


def test_bf16_layout_checks():
    """The rules of the tensor-core paths, checked on CPU tensors (on the
    card the wrappers apply them to every bf16 call): unit stride on the
    staged axis, strides in multiples of 8 elements, 16-byte alignment."""
    h = torch.zeros(64, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 256, dtype=torch.bfloat16)
    xent_kernel._check_bf16_layout(h, w)                        # untied head
    xent_kernel._check_bf16_layout(h, torch.zeros(256, 32, dtype=torch.bfloat16).T)
    for bad_h, bad_w in ((h.T.contiguous().T, w),               # h strided on d
                         (h, torch.zeros(32, 512, dtype=torch.bfloat16)[:, ::2]),
                         (torch.zeros(64, 36, dtype=torch.bfloat16)[:, 1:33], w),
                         (h[:, :28], w[:28])):                  # d not a multiple of 8
        with pytest.raises(ValueError):
            xent_kernel._check_bf16_layout(bad_h, bad_w)
    q = torch.zeros(2, 64, 4, 16, dtype=torch.bfloat16)
    kv = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    attn_kernel._check_bf16_layout(q, kv, kv)
    attn_kernel._check_bf16_layout(q, kv[:, :, :1], kv[:, :, 1:])   # one KV head of two
    wide = torch.zeros(2, 64, 2, 20, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn_kernel._check_bf16_layout(q, wide[..., :16], kv)      # head stride 20
    with pytest.raises(ValueError):
        attn_kernel._check_bf16_layout(q, kv.flatten()[1:2049].view(2, 64, 2, 8), kv)
