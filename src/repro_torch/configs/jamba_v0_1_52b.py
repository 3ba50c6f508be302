"""Jamba-v0.1 (52B total) — hybrid Mamba/attention + MoE [arXiv:2403.19887].

1 attention layer per block of 8 (1:7 attn:mamba); MoE every 2nd layer,
16 experts top-2.  Mamba mixer: d_state=16, expand=2, headdim=64 (the
Mamba2/SSD mixer stands in for Jamba's Mamba1, as in the JAX package).

A copy of ``repro.configs.jamba_v0_1_52b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    num_experts=16, top_k=2, moe_d_ff=14336, moe_every=2,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=8,
    source="arXiv:2403.19887",
)
