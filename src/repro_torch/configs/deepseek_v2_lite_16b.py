"""DeepSeek-V2-Lite (16B total) — MLA + fine-grained MoE [arXiv:2405.04434].

Assignment line: 27L d_model=2048 16H d_ff=1408 vocab=102400, MoE 64e top-6,
MLA kv_lora=512, 2 shared experts.  (The bracket's "160 routed" belongs to the
full V2; the Lite model and the assignment's main line use 64 routed experts.)
First layer is dense (d_ff=10944) per the model card; remaining layers MoE with
per-expert hidden 1408.

A copy of ``repro.configs.deepseek_v2_lite_16b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, rope_theta=1e4,
    mla=True, kv_lora_rank=512, qk_rope_head_dim=64, qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=64, num_shared_experts=2, top_k=6, moe_d_ff=1408,
    moe_every=1, first_dense=1,
    source="arXiv:2405.04434",
)
