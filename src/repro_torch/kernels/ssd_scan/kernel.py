"""SSD intra-chunk scan: the CUDA kernel's wrapper and its plain PyTorch
version.

``ssd_intra_chunk`` replaces the Pallas kernel
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``. Per (chunk, head), with
``cum = cumsum(dt·A)`` over the chunk, it computes the diagonal-block output
``Y_diag = ((C·Bᵀ) ⊙ L)·(x·dt)`` with ``L[i,j] = exp(cum_i − cum_j)`` for
i ≥ j, the chunk's state ``Σ_j exp(cum_last − cum_j)(x·dt)_j ⊗ B_j`` and
its decay ``exp(cum_last)``. B and C come in their group layout
(N, cl, G, ds) and head h reads group h // (nh/G); the JAX wrapper repeats
them to every head first, which is the case G = nh here.

For a tensor on the CPU it computes ``ssd_intra_chunk_plain``; for a CUDA
tensor it launches ``csrc/ssd_scan.cu`` or raises. It never falls back.
On meta tensors (``repro_torch.analysis``) it returns its output's shape
and dtype and records one launch of ``cost()``, the kernel's operations
and bytes, which ``chip_smoke.py``'s bound uses too.

In bf16 (the training dtype) the kernel runs on the tensor cores
(``wgmma``, fed by TMA): C·Bᵀ once per (chunk, group, row tile) for every
head of the group, P = C·Bᵀ ⊙ L ⊙ dt as two bf16 terms (its rounding and
the rounding of the remainder), the state's scaled x rounded to bf16 once,
f32 accumulators. Its bound is then its bytes, 100 MB of the 139 MB at the
training shape being the f32 outputs. TMA takes x, B and C where they lie,
so their base addresses must be 16-byte aligned and the strides of their
dimensions longer than 1 multiples of 8 elements; ``_check_bf16_layout``
raises on anything else (the model's layouts all pass). In f32 (the
``--precision f32`` comparison path) it runs f32 FMAs on the CUDA cores,
with no TF32. Its design and what it leaves for later are in the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 128


def ssd_intra_chunk_plain(x, dt, A, B, C):
    """x: (N, cl, nh, hd); dt: (N, cl, nh); A: (nh,); B/C: (N, cl, G, ds)
    with nh % G == 0. -> (y_diag (N, cl, nh, hd), states (N, nh, hd, ds),
    decays (N, nh)), all f32: the einsums of ``_ssd_kernel`` in f32, the
    decay taken as exp(where(i ≥ j, cum_i − cum_j, −inf))."""
    N, cl, nh, hd = x.shape
    rep = nh // B.shape[2]
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Bh = B.to(torch.float32).repeat_interleave(rep, dim=2)
    Ch = C.to(torch.float32).repeat_interleave(rep, dim=2)
    cum = torch.cumsum(dtf * A.to(torch.float32), dim=1).transpose(1, 2)  # (N, nh, cl)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, diff, torch.full_like(diff, float("-inf"))))
    xdt = xf * dtf[..., None]                                             # (N, cl, nh, hd)
    CB = torch.einsum("nihd,njhd->nhij", Ch, Bh)
    y = torch.einsum("nhij,njhp->nihp", CB * L, xdt)
    w = torch.exp(cum[..., -1:] - cum).transpose(1, 2)                     # (N, cl, nh)
    states = torch.einsum("njhp,njhd->nhpd", xdt * w[..., None], Bh)
    return y, states, torch.exp(cum[..., -1])


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_intra_chunk
    if fn.argtypes is None:    # undeclared, ctypes passes pointers as 32-bit ints
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [P, L, L, L, P, L, L, L, P, P, L, L, L, P, L, L, L,
                       P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError("ssd_intra_chunk wants x (N,cl,nh,hd), dt (N,cl,nh),"
                         " A (nh,), B/C (N,cl,G,ds)")
    N, cl, nh, hd = x.shape
    G, ds = B.shape[2], B.shape[3]
    if (dt.shape != (N, cl, nh) or A.shape != (nh,) or C.shape != B.shape
            or B.shape[:2] != (N, cl)):
        raise ValueError(f"ssd_intra_chunk shapes disagree: x {tuple(x.shape)},"
                         f" dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if G == 0 or nh % G:
        raise ValueError(f"{nh} heads do not group over {G} B/C groups")
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_intra_chunk head_dim {hd} not in {HEAD_DIMS}")
    if not 1 <= cl <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk chunk length {cl} not in "
                         f"[1, {MAX_CHUNK}]")
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"ssd_intra_chunk state size {ds} not in "
                         f"[1, {MAX_STATE}]")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_intra_chunk takes f32 or bf16 x/B/C of one "
                        f"dtype; got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_intra_chunk takes f32 dt and A; got {dt.dtype},"
                        f" {A.dtype}")
    if not (x.device == dt.device == A.device == B.device == C.device):
        raise ValueError("ssd_intra_chunk inputs on different devices")
    for t in (x, B, C):
        if t.stride(3) != 1 or min(t.stride()) < 0:
            raise ValueError("ssd_intra_chunk takes a unit stride on the last"
                             " axis of x, B and C and no negative strides")
    if min(dt.stride()) < 0 or A.stride(0) != 1:
        raise ValueError("ssd_intra_chunk takes a contiguous A and no "
                         "negative dt strides")
    if nh > 65535 or N * (-(-cl // 64) + 1) >= 2**31:
        raise ValueError("ssd_intra_chunk grid out of range")
    if x.dtype == torch.bfloat16 and x.device.type == "cuda":
        _check_bf16_layout(x, B, C)


def _check_bf16_layout(x, B, C):
    """What the tensor-core route's 4-D TMA descriptors take: 16-byte
    aligned base addresses and, on every outer dimension longer than 1, a
    stride in multiples of 16 bytes (8 elements)."""
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                                    if n > 1):
            raise ValueError(
                f"ssd_intra_chunk in bf16 takes 16-byte aligned tensors whose "
                f"outer strides are multiples of 8 elements; {name} has strides "
                f"{t.stride()} at offset {t.data_ptr() % 16} bytes from 16")


def cost(N: int, cl: int, nh: int, hd: int, G: int, ds: int,
         dtype=torch.bfloat16) -> tuple:
    """(operations, bytes) of one launch: the function's own work,
    whatever computes it, per (chunk, head) the live (i >= j) pairs of
    2(ds + hd) operations (C·Bᵀ counted for every head) and 2·cl·hd·ds for
    the state (the bf16 kernel computes C·Bᵀ once per group, about half
    of this); against reading x, B, C (``dtype``), dt and A (f32) once and
    writing the three f32 outputs once."""
    esz = torch.empty((), dtype=dtype).element_size()
    ops = N * nh * (cl * (cl + 1) / 2 * 2 * (ds + hd) + 2 * cl * hd * ds)
    nbytes = ((N * cl * nh * hd + 2 * N * cl * G * ds) * esz       # x, B, C
              + (N * cl * nh + nh) * 4                               # dt, A
              + (N * cl * nh * hd + N * nh * hd * ds + N * nh) * 4)  # outputs
    return ops, nbytes


def ssd_intra_chunk(x, dt, A, B, C):
    """x: (N, cl, nh, hd); dt: (N, cl, nh) f32; A: (nh,) f32; B/C:
    (N, cl, G, ds). -> (y_diag, states, decays) in f32, as
    ``ssd_intra_chunk_plain``. On meta tensors it records ``cost`` with
    ``analysis.count`` and returns the kernel's outputs, shapes and dtypes
    only."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_intra_chunk runs on cuda, cpu or meta, not "
                         f"{x.device}")
    N, cl, nh, hd = x.shape
    G, ds = B.shape[2], B.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        from repro_torch.analysis import count
        count.kernel("ssd_scan", *cost(N, cl, nh, hd, G, ds, x.dtype),
                     x.dtype)
        return (torch.empty((N, cl, nh, hd), **f32),
                torch.empty((N, nh, hd, ds), **f32),
                torch.empty((N, nh), **f32))
    y = torch.empty((N, cl, nh, hd), **f32)
    states = torch.empty((N, nh, hd, ds), **f32)
    decays = torch.empty((N, nh), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), *x.stride()[:3],
                     dt.data_ptr(), *dt.stride(), A.data_ptr(),
                     B.data_ptr(), *B.stride()[:3],
                     C.data_ptr(), *C.stride()[:3],
                     y.data_ptr(), states.data_ptr(), decays.data_ptr(),
                     N, cl, nh, hd, G, ds, _DTYPES[x.dtype], stream)
    launch_count.count(ssd_intra_chunk, "ssd_scan")
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {err}")
    return y, states, decays


ssd_intra_chunk.launches = 0
