"""Mamba2-2.7B — attention-free SSM, SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*2560 = 5120, headdim=64 -> 80 SSM heads, d_state=128.

A copy of ``repro.configs.mamba2_2_7b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256, ssm_ngroups=1,
    source="arXiv:2405.21060",
)
