"""InternVL2-2B — InternViT + InternLM2 backbone [arXiv:2404.16821].

The vision encoder (InternViT) + MLP projector is a STUB per the carve-out:
``input_specs`` provides precomputed patch embeddings (num_image_tokens,
d_model) that are prepended to the text sequence.  Backbone = InternLM2-1.8B
dims with the VLM's extended vocab (92553).

A copy of ``repro.configs.internvl2_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92553, rope_theta=1e6,
    frontend="vision", num_image_tokens=256,
    source="arXiv:2404.16821",
)
