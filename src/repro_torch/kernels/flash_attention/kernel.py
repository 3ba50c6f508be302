"""Blocked GQA attention: the CUDA kernel's wrapper and its plain PyTorch
version.

``flash_attention`` replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It takes the
model's layout directly, q (B, Sq, H, hd) and k/v (B, Sk, K, hd), and maps
query head h to KV head h // (H/K) inside the kernel. For a tensor on the
CPU it computes ``attention_plain``; for a CUDA tensor it launches
``csrc/flash_attention.cu`` or raises. It never falls back.

The kernel is bound by its operations: 4·hd per live (query, key) pair of
each (batch, head), with S(S+1)/2 live pairs under the causal mask. In bf16
it runs on the tensor cores; in f32 on the CUDA cores. Its design and what
it leaves for later are in the source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
NEG_INF = -1e30


def attention_plain(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd) in q.dtype.
    f32 scores and softmax, masked scores at the finite -1e30
    (``attention_ref``'s math, on the GQA layout)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.to(torch.float32).reshape(B, Sq, K, rep, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qf, k.to(torch.float32)) / (hd ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:    # undeclared, ctypes passes pointers as 32-bit ints
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, L, L, P, L, L, L, P, L, L, L, P,
                       I, I, I, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,Sq,H,hd), k/v (B,Sk,K,hd)")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs on different devices")
    for t in (q, k, v):
        if t.stride(3) != 1 or min(t.stride()) < 0:
            raise ValueError("flash_attention takes a unit stride on head_dim "
                             "and no negative strides")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if max(B, H) > 65535 or max(Sq, k.shape[1]) >= 2**31:
        raise ValueError("flash_attention grid out of range")
    if q.dtype == torch.bfloat16 and q.device.type == "cuda":
        _check_bf16_layout(q, k, v)


def _check_bf16_layout(q, k, v):
    """The tensor-core path stages 16-byte rows of K and V and reads q in
    pairs: strides in multiples of 8 elements, 16-byte aligned tensors."""
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention in bf16 takes strides in multiples of 8 "
                f"elements and 16-byte aligned tensors; got strides "
                f"{t.stride()}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd) in q.dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), *q.stride()[:3],
                     k.data_ptr(), *k.stride()[:3],
                     v.data_ptr(), *v.stride()[:3],
                     o.data_ptr(), B, Sq, Sk, H, K, hd, int(causal),
                     window or 0, _DTYPES[q.dtype], stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o


flash_attention.launches = 0
