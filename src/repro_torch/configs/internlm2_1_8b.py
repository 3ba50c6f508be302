"""InternLM2-1.8B — dense GQA decoder [arXiv:2403.17297].

A copy of ``repro.configs.internlm2_1_8b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, rope_theta=1e6,
    source="arXiv:2403.17297",
)
