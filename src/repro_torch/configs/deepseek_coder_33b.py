"""DeepSeek-Coder-33B — dense llama-arch GQA [arXiv:2401.14196].

A copy of ``repro.configs.deepseek_coder_33b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, rope_theta=1e5,
    source="arXiv:2401.14196",
)
