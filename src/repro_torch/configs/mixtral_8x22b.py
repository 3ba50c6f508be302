"""Mixtral-8x22B — sparse MoE (8 experts top-2), GQA, SWA [arXiv:2401.04088].

Assignment specifies SWA; we use window 4096 (Mistral lineage).

A copy of ``repro.configs.mixtral_8x22b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768, rope_theta=1e6,
    num_experts=8, top_k=2, moe_d_ff=16384, moe_every=1,
    sliding_window=4096,
    source="arXiv:2401.04088",
)
