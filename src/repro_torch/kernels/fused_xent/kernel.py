"""Fused softmax cross-entropy: the CUDA kernel's wrapper and its plain
PyTorch version.

``fused_xent`` replaces the Pallas kernel
``repro/kernels/fused_xent/kernel.py::_xent_kernel``. For a tensor on the
CPU it computes ``xent_plain``; for a CUDA tensor it launches
``csrc/fused_xent.cu`` or raises. It never falls back.
On meta tensors (``repro_torch.analysis``) it returns its output's shape
and dtype and records one launch of ``cost()``, the kernel's operations
and bytes, which ``chip_smoke.py``'s bound uses too.

The kernel is bound by its 2·N·d·Vp operations (compute, not bytes). In
bf16 it runs on the tensor cores (wgmma fed by TMA) and takes W as a
row-major head or as a transposed embedding; in f32 it runs on the CUDA
cores through any strides. Its design and what it leaves for later are in
the source.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launch_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN = 128          # tokens per block, as in the source
BV = 128          # vocab columns per tile, as in the source


def xent_plain(h, w, labels, vocab_size: int):
    """h: (N, d); w: (d, Vp); labels: (N,) -> nll (N,) f32, in f32 with
    the columns ``>= vocab_size`` masked to -1e30 (``xent_ref``'s math)."""
    logits = h.to(torch.float32) @ w.to(torch.float32)
    Vp = logits.shape[-1]
    if vocab_size != Vp:
        col = torch.arange(Vp, device=logits.device)
        logits = torch.where(col < vocab_size, logits,
                             torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - gold


def _lib():
    lib = build.load("fused_xent")
    fn = lib.repro_fused_xent_fwd
    if fn.argtypes is None:    # undeclared, ctypes passes pointers as 32-bit ints
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, L, P, L, L, P, P, P, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _nsplit(device, N: int, Vp: int, dtype=torch.bfloat16) -> int:
    """Vocab splits per token tile, for the device's SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_count(sms, -(-N // BN), -(-Vp // BV), dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def split_count(sms: int, n_tiles: int, n_vt: int, one_per_sm: bool = True) -> int:
    """The number of blocks that share each token tile's vocab sweep.

    bf16 (``one_per_sm``): the kernel fits one block per SM, so the grid of
    ``n_tiles × s`` blocks runs in ceil(n_tiles·s / sms) waves, each as
    long as one block: ceil(n_vt / s) vocab tiles plus about one more for
    filling the ring and writing the partials. Take the s in 1..n_vt that
    makes the busiest SM's share the smallest, the smallest such s (fewer
    partials to fold). f32: enough blocks for about four per SM. Either
    way s is then made the count of non-empty ranges that
    ``vocab_ranges`` cuts, so every split owns at least one vocab tile."""
    if one_per_sm:
        want = min(range(1, n_vt + 1),
                   key=lambda s: -(-n_tiles * s // sms) * (-(-n_vt // s) + 1))
    else:
        want = min(n_vt, max(1, -(-4 * sms // n_tiles)))
    per = -(-n_vt // want)
    return -(-n_vt // per)


def vocab_ranges(n_vt: int, nsplit: int) -> list:
    """The vocab tiles [begin, end) that each split of the kernel sweeps,
    as ``csrc/fused_xent.cu`` cuts them."""
    per = -(-n_vt // nsplit)
    return [(y * per, min((y + 1) * per, n_vt)) for y in range(nsplit)]


def _check(h, w, labels, vocab_size):
    if h.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"fused_xent wants h (N, d), w (d, Vp), labels (N,); "
                         f"got {tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    N, d = h.shape
    if w.shape[0] != d or labels.shape[0] != N:
        raise ValueError(f"fused_xent shapes disagree: h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}, labels {tuple(labels.shape)}")
    if h.dtype not in _DTYPES or w.dtype != h.dtype:
        raise TypeError(f"fused_xent takes f32 or bf16 h and w of one dtype; "
                        f"got {h.dtype}, {w.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"fused_xent takes int32 labels, got {labels.dtype}")
    if not labels.is_contiguous():
        raise ValueError("fused_xent takes contiguous labels")
    if not (h.device == w.device == labels.device):
        raise ValueError(f"fused_xent inputs on different devices: "
                         f"{h.device}, {w.device}, {labels.device}")
    if min(h.stride()) < 0 or min(w.stride()) < 0:
        raise ValueError("fused_xent takes no negative strides")
    if not 0 < vocab_size <= w.shape[1]:
        raise ValueError(f"vocab_size {vocab_size} outside (0, {w.shape[1]}]")
    if N >= 2**31 or d >= 2**31 or w.shape[1] >= 2**31:
        raise ValueError("fused_xent sizes must fit in int32")
    if h.dtype == torch.bfloat16 and h.device.type == "cuda":
        _check_bf16_layout(h, w)


def _check_bf16_layout(h, w):
    """What the tensor-core path's TMA descriptors take: h with unit stride
    on d, W as a row-major (d, Vp) head or the transposed view of a (Vp, d)
    embedding, row strides in multiples of 16 bytes (8 elements) and
    16-byte aligned base pointers."""
    d, Vp = w.shape
    w_rows = w.stride(0) if w.stride(1) == 1 else w.stride(1)
    ok = (h.stride(1) == 1 and (w.stride(0) == 1 or w.stride(1) == 1)
          and d % 8 == 0 and (w.stride(1) != 1 or Vp % 8 == 0)
          and h.stride(0) % 8 == 0 and w_rows % 8 == 0
          and h.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"fused_xent in bf16 takes h with unit stride on d and W with a "
            f"unit stride on one axis, d and rows in multiples of 8 elements, "
            f"16-byte aligned; got h {tuple(h.shape)} strides {h.stride()}, "
            f"w {tuple(w.shape)} strides {w.stride()}")


def cost(N: int, d: int, Vp: int, dtype=torch.bfloat16) -> tuple:
    """(operations, bytes) of one launch: the 2·N·d·Vp of the products,
    against reading h, W and the labels once and writing the nll once.
    The logits are never stored."""
    esz = torch.empty((), dtype=dtype).element_size()
    return 2.0 * N * d * Vp, (N * d + d * Vp) * esz + N * 4 + N * 4


def fused_xent(h, w, labels, vocab_size: int):
    """h: (N, d); w: (d, Vp), any strides (a transposed embedding is taken
    as it is); labels: (N,) int32 -> nll (N,) f32. On meta tensors it
    records ``cost`` with ``analysis.count`` and returns the kernel's
    output, shape and dtype only."""
    _check(h, w, labels, vocab_size)
    if h.device.type == "cpu":
        return xent_plain(h, w, labels, vocab_size)
    if h.device.type == "meta":
        from repro_torch.analysis import count
        count.kernel("fused_xent", *cost(*h.shape, w.shape[1], h.dtype),
                     h.dtype)
        return torch.empty((h.shape[0],), dtype=torch.float32, device="meta")
    if h.device.type != "cuda":
        raise ValueError(f"fused_xent runs on cuda, cpu or meta, not "
                         f"{h.device}")
    N, d = h.shape
    Vp = w.shape[1]
    nsplit = _nsplit(h.device, N, Vp, h.dtype)
    out = torch.empty((N,), dtype=torch.float32, device=h.device)
    partial = torch.empty((3, nsplit, N), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        err = _lib()(h.data_ptr(), h.stride(0), h.stride(1),
                     w.data_ptr(), w.stride(0), w.stride(1),
                     labels.data_ptr(), out.data_ptr(), partial.data_ptr(),
                     N, d, Vp, vocab_size, nsplit, _DTYPES[h.dtype], stream)
    launch_count.count(fused_xent, "fused_xent")
    if err != 0:
        raise RuntimeError(f"fused_xent kernel launch failed: CUDA error {err}")
    return out


fused_xent.launches = 0
