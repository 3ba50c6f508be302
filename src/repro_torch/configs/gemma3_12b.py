"""Gemma3-12B — dense GQA, 5 local (window 1024) : 1 global, 128k context
[hf:google/gemma-3-1b-pt family card].  head_dim=256.

A copy of ``repro.configs.gemma3_12b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, rope_theta=1e6, tie_embeddings=True,
    sliding_window=1024, global_every=6,
    source="hf:google/gemma-3-1b-pt",
)
