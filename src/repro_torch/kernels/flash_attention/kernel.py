"""Blocked GQA attention: the CUDA kernel's wrapper and its plain PyTorch
version.

``flash_attention`` replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel``. It takes the
model's layout directly, q (B, Sq, H, hd) and k/v (B, Sk, K, hd), and maps
query head h to KV head h // (H/K) inside the kernel. For a tensor on the
CPU it computes ``attention_plain``; for a CUDA tensor it launches
``csrc/flash_attention.cu`` or raises. It never falls back.
On meta tensors (``repro_torch.analysis``) it returns its output's shape
and dtype and records each launch's operations and bytes
(``launch_costs``). ``cost()``, the function's own operations and bytes,
is the bound ``chip_smoke.py`` uses; the launches do more at hd = 256.

The kernel is bound by its operations: 4·hd per live (query, key) pair of
each (batch, head), with S(S+1)/2 live pairs under the causal mask. At
hd = 256 in bf16 one call is two launches, each for a 128-wide half of v
and o, both computing the whole q·k (so 6·hd a pair). In bf16
it runs on the tensor cores (wgmma fed by TMA) on a persistent grid whose
blocks take the work lists that ``schedule`` builds here; in f32 on the
CUDA cores. Its design and what it leaves for later are in the source.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Optional

import torch

from repro_torch.kernels import build, launch_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
NEG_INF = -1e30
TQ = 128          # query rows of a bf16 work item, as in the source
ITEM_COST = 1     # an item's fixed cost in key tiles (Q, the first S, the store)
_SCHED: dict = {}  # (device, schedule key) -> the work lists on the device


def attention_plain(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd) in q.dtype.
    f32 scores and softmax, masked scores at the finite -1e30
    (``attention_ref``'s math, on the GQA layout). ``q_offset`` is the
    position of q's first row counted from k's first row, so a chunk of
    rows against a range of keys is masked as in the whole sequence."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.to(torch.float32).reshape(B, Sq, K, rep, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qf, k.to(torch.float32)) / (hd ** 0.5)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
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
                       I, I, I, I, I, I, I, I, I, P, I, P]
        fn.restype = ctypes.c_int
    return fn


def key_tile(hd: int) -> int:
    """Keys per tile of the bf16 kernel, as in the source."""
    return 64 if hd >= 128 else 128


def launches_per_call(hd: int, dtype) -> int:
    """Kernel launches of one call: two in bf16 at hd = 256 (one 128-wide
    half of v and o each, as the source explains), else one."""
    return 2 if hd == 256 and dtype == torch.bfloat16 else 1


def work_items(B: int, H: int, Sq: int, Sk: int, causal: bool,
               window: int, hd: int) -> list:
    """(q0, h, b, kt0, ntiles) of each bf16 work item, in item order
    (heaviest causal query tiles first), as the source's ``work_item``
    computes them: query rows [q0, q0 + TQ) of head h of batch b visit key
    tiles kt0 .. kt0 + ntiles - 1. An item with no live key gets one tile,
    all masked. ``window`` 0 means none."""
    tk = key_tile(hd)
    n_qt = -(-Sq // TQ)
    out = []
    for item in range(n_qt * H * B):
        hb = item % (H * B)
        q0 = (n_qt - 1 - item // (H * B)) * TQ
        q_last = min(q0 + TQ, Sq) - 1
        k_hi = min(Sk, q_last + 1) if causal else Sk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        kt0 = k_lo // tk
        ntiles = -(-k_hi // tk) - kt0
        if ntiles <= 0:
            kt0, ntiles = 0, 1
        out.append((q0, hb % H, hb // H, kt0, ntiles))
    return out


@functools.lru_cache(maxsize=64)
def schedule(B: int, H: int, Sq: int, Sk: int, causal: bool, window: int,
             hd: int, sms: int) -> tuple:
    """The persistent grid's work lists: each item (longest first) goes to
    the block with the least work so far, counting ntiles + ITEM_COST.
    -> (grid, table) with table = grid + 1 offsets, then the items of
    block 0, block 1, ..., as the kernel reads them."""
    items = work_items(B, H, Sq, Sk, causal, window, hd)
    grid = min(sms, len(items))
    heap = [(0, blk) for blk in range(grid)]
    lists = [[] for _ in range(grid)]
    for i in sorted(range(len(items)), key=lambda i: -items[i][4]):
        load, blk = heapq.heappop(heap)
        lists[blk].append(i)
        heapq.heappush(heap, (load + items[i][4] + ITEM_COST, blk))
    starts = [0]
    for lst in lists:
        starts.append(starts[-1] + len(lst))
    return grid, tuple(starts + [i for lst in lists for i in lst])


def _work_lists(device, B, H, Sq, Sk, causal, window, hd):
    """``schedule`` for this card, as an int32 tensor on it (made once per
    shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    key = (str(device), B, H, Sq, Sk, causal, window, hd, sms)
    hit = _SCHED.get(key)
    if hit is None:
        grid, table = schedule(B, H, Sq, Sk, causal, window, hd, sms)
        hit = _SCHED[key] = (grid, torch.tensor(table, dtype=torch.int32,
                                                device=device))
    return hit


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
    """What the tensor-core path's 4-D TMA descriptors take: the outer
    strides in multiples of 16 bytes (8 elements) and 16-byte aligned base
    pointers."""
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash_attention in bf16 takes strides in multiples of 8 "
                f"elements and 16-byte aligned tensors; got strides "
                f"{t.stride()}")


def live_pairs(Sq: int, Sk: int, causal: bool = True,
               window: Optional[int] = None) -> int:
    """(query, key) pairs the mask keeps, per (batch, head): query i sees
    keys j <= i (causal) and j > i - window, within [0, Sk)."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i, max=Sk - 1) if causal else torch.full_like(i, Sk - 1)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def cost(B: int, Sq: int, Sk: int, H: int, K: int, hd: int,
         dtype=torch.bfloat16, causal: bool = True,
         window: Optional[int] = None) -> tuple:
    """(operations, bytes) of one launch: 4·hd operations per live (query,
    key) pair of each (batch, head), against reading q, k, v and writing
    o once."""
    esz = torch.empty((), dtype=dtype).element_size()
    ops = 4.0 * B * H * hd * live_pairs(Sq, Sk, causal, window)
    return ops, (2 * B * Sq * H * hd + 2 * B * Sk * K * hd) * esz


def launch_costs(B: int, Sq: int, Sk: int, H: int, K: int, hd: int,
                 dtype=torch.bfloat16, causal: bool = True,
                 window: Optional[int] = None) -> list:
    """[(operations, bytes)] of each launch of one call, as the kernel does
    the work: ``[cost(...)]``, except at hd = 256 in bf16, where each of
    the two launches computes the whole q·k (2·hd a live pair) and half of
    P·v (hd a pair), and reads all of q and k and half of v, and writes
    half of o."""
    if launches_per_call(hd, dtype) == 1:
        return [cost(B, Sq, Sk, H, K, hd, dtype, causal, window)]
    esz = torch.empty((), dtype=dtype).element_size()
    ops = 3.0 * B * H * hd * live_pairs(Sq, Sk, causal, window)
    q_o, k_v = B * Sq * H * hd, B * Sk * K * hd
    nbytes = (q_o + k_v + k_v // 2 + q_o // 2) * esz
    return [(ops, nbytes)] * 2


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) -> (B, Sq, H, hd) in q.dtype.
    On meta tensors it records ``launch_costs`` with ``analysis.count``
    and returns the kernel's output, shape and dtype only."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        from repro_torch.analysis import count
        B, Sq, H, hd = q.shape
        for ops, nbytes in launch_costs(B, Sq, k.shape[1], H, k.shape[2],
                                        hd, q.dtype, bool(causal), window):
            count.kernel("flash_attention", ops, nbytes, q.dtype)
        return torch.empty((B, Sq, H, hd), dtype=q.dtype, device="meta")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    grid, lists = 0, None
    if q.dtype == torch.bfloat16:
        grid, lists = _work_lists(q.device, B, H, Sq, Sk, bool(causal),
                                  window or 0, hd)
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), *q.stride()[:3],
                     k.data_ptr(), *k.stride()[:3],
                     v.data_ptr(), *v.stride()[:3],
                     o.data_ptr(), B, Sq, Sk, H, K, hd, int(causal),
                     window or 0, _DTYPES[q.dtype],
                     None if lists is None else lists.data_ptr(), grid, stream)
    for _ in range(launches_per_call(hd, q.dtype)):
        launch_count.count(flash_attention, "flash_attention")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o


flash_attention.launches = 0
