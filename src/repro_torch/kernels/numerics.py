"""Kernel-vs-plain tolerances and shape grids, the port's own copy of
``repro.kernels.numerics`` (a test holds the two tables equal).

kernel -> dtype name -> (rtol, atol). bf16 tolerances cover input rounding
(eps 2^-8) plus accumulation-order differences; f32 tolerances are a few
ulps of the reduction reassociation.
"""
from __future__ import annotations

TOLERANCES = {
    "fused_xent": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    "flash_attention": {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)},
    "ssd_scan": {"float32": (1e-3, 1e-3), "bfloat16": (3e-2, 3e-2)},
}

# fused_xent: (N, d, Vp, V)
XENT_SHAPES = [
    (128, 64, 512, 500),      # padded vocab, aligned tokens
    (256, 32, 1024, 1024),    # exact vocab
    (384, 32, 256, 256),      # N=B·S not a multiple of the 256 token tile
    (96, 48, 1024, 1000),     # ragged token axis
    (128, 64, 256, 256),      # paper-transformer-tiny head (d=64, V=256)
]

# flash_attention: (BH, S, hd, causal, window)
ATTN_SHAPES = [
    (4, 256, 64, True, None),
    (2, 256, 64, True, 64),     # sliding window
    (8, 64, 16, True, None),    # paper-transformer-tiny (B·H=8, S=64, hd=16)
    (2, 192, 32, True, 64),     # seq not 128-aligned
    (1, 128, 32, False, None),  # non-causal (encoder/cross)
]

# Edges of the bf16 wgmma + TMA routes (the port's own; the JAX package has
# no counterpart): every head dim, ragged S (TMA zero-fills rows past S,
# the mask drops key columns past Sk), a window that starts inside a key
# tile, non-causal, and the training paths' shapes: paper-transformer's
# 16/8 GQA, paper-moe's 12/4 (three query heads a KV head) and the reduced
# architectures' local layers (hd 32, window 16).
# flash_attention: (B, S, H, K, hd, causal, window)
ATTN_EDGES = (
    [(2, 100, 4, 2, hd, True, None) for hd in (16, 32, 64, 128, 256)]
    + [(2, 192, 4, 2, hd, False, None) for hd in (16, 32, 64, 128, 256)]
    + [(1, 192, 8, 2, hd, True, 64) for hd in (16, 32, 64, 128, 256)]
    + [(1, 512, 4, 1, 64, True, 100),     # first visited key tile > 0
       (2, 64, 4, 2, 32, True, 16),       # reduced Mixtral, Gemma3 local
       (8, 1024, 16, 8, 64, True, None),  # paper-transformer
       (8, 1024, 12, 4, 64, True, None),  # paper-moe
       (1, 2048, 16, 8, 256, True, 1024)]  # Gemma3-12B's local layer
)

# fused_xent: (N, d, Vp, V, tied) -- tied: W is the transposed view of a
# (Vp, d) embedding (a K-major operand), else a (d, Vp) head (MN-major)
XENT_EDGES = [
    (2048, 1024, 32768, 32000, True),    # large, tied, padded vocab
    (96, 64, 512, 500, True),            # N below one token tile
    (96, 48, 1024, 1000, False),         # d = 48: depth zero-filled to 64
    (384, 48, 256, 200, True),
    (384, 64, 1024, 1024, False),
    (200, 32, 384, 384, True),           # d = 32, three vocab tiles
    (128, 256, 512, 512, False),         # the reduced architectures' heads
    (128, 256, 512, 512, True),          # (starcoder2, gemma3 tie them)
    (8192, 768, 32768, 32768, False),    # paper-moe
]

# ssd_scan: (b, S, nh, hd, G, ds, chunk)
SSD_SHAPES = [
    (2, 128, 4, 32, 1, 16, 32),
    (2, 64, 8, 16, 1, 32, 16),   # paper-ssm-tiny (d_inner=128, hd=16)
    (1, 96, 2, 16, 2, 8, 32),    # S not a multiple of the chunk
]

# Edges of the bf16 wgmma + TMA route of ssd_scan (the port's own; the JAX
# package has no counterpart): every head dim (x tiles are 64 wide, TMA
# zero-fills past hd), state sizes 8 to 128 (B/C boxes of 32, zero-filled
# past ds), chunks of 25 (ragged), 64, 128, 192 (an odd tile count: one
# pair of row tiles is a single tile) and 256, one and two groups, 24
# blocks of pairs whose 8 heads split unevenly into 5 slices on a 132-SM
# card, and the training shape. init_dt: dt drawn as the model's init
# draws it, softplus(N(log(expm1(0.01)), 1)), so that every 64-position
# tile of a long chunk weighs above the tolerance.
# ssd_scan: (b, S, nh, hd, G, ds, chunk, init_dt)
SSD_EDGES = [
    (2, 128, 4, 16, 1, 8, 64, False),
    (2, 128, 4, 32, 2, 16, 64, False),
    (1, 100, 3, 64, 1, 32, 32, False),     # cl = 25
    (2, 256, 4, 32, 1, 128, 128, True),
    (2, 384, 4, 64, 1, 64, 192, True),
    (1, 512, 6, 16, 2, 128, 256, True),
    (3, 1024, 8, 64, 1, 128, 256, True),   # 5 head slices of 8 heads
    (2, 64, 32, 16, 1, 32, 16, True),      # reduced Jamba and Mamba2
    (8, 1024, 32, 64, 1, 128, 256, True),  # the training shape
]


def gqa_split(bh: int):
    """(B, H, K) for a flattened B·H of ``ATTN_SHAPES``: four query heads
    over two KV heads where B·H allows it, so every grid cell exercises the
    GQA head mapping (B·H=8 gives the tiny tier's B=2, H=4, K=2)."""
    if bh % 4 == 0:
        return bh // 4, 4, 2
    if bh % 2 == 0:
        return bh // 2, 2, 1
    return bh, 1, 1
