"""The ``paper_transformer`` zoo (copied from
``repro.configs.paper_transformer``): one family per mixer class, dense
attention, GShard top-2 MoE and Mamba2/SSD, each in two tiers: ``tiny`` is
the CPU test tier, ``base`` the single-card tier the port trains on the
H100."""
from repro_torch.configs.base import ModelConfig

PAPER_TRANSFORMER_TINY = ModelConfig(
    name="paper-transformer-tiny", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, tie_embeddings=True,
    source="arXiv:1603.05544 §5 workloads, transformer counterpart (CI tier)",
)

PAPER_TRANSFORMER = ModelConfig(
    name="paper-transformer", family="dense",
    num_layers=16, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
    d_ff=4096, vocab_size=32768, rope_theta=1e5,
    source="arXiv:1603.05544 §5 workloads, transformer counterpart "
           "(single-host tier, ~0.4B params)",
)

PAPER_MOE_TINY = ModelConfig(
    name="paper-moe-tiny", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, tie_embeddings=True,
    num_experts=4, top_k=2, moe_d_ff=128, moe_every=1,
    # no-drop capacity: keeps tiny-tier parity runs deterministic in the
    # face of capacity drops that depend on group composition
    moe_capacity_factor=1e9,
    source="GShard-style top-2 MoE, CI tier",
)

PAPER_MOE = ModelConfig(
    name="paper-moe", family="moe",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=3072, vocab_size=32768, rope_theta=1e5,
    num_experts=8, top_k=2, moe_d_ff=1536, moe_every=2,
    source="GShard-style top-2 MoE, single-host tier",
)

PAPER_SSM_TINY = ModelConfig(
    name="paper-ssm-tiny", family="ssm",
    num_layers=2, d_model=64, vocab_size=256, tie_embeddings=True,
    ssm_state=32, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
    source="Mamba2/SSD mixer stack, CI tier",
)

PAPER_SSM = ModelConfig(
    name="paper-ssm", family="ssm",
    num_layers=24, d_model=1024, vocab_size=32768,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    source="Mamba2/SSD mixer stack, single-host tier",
)

ZOO = {
    ("transformer", "tiny"): PAPER_TRANSFORMER_TINY,
    ("transformer", "base"): PAPER_TRANSFORMER,
    ("moe", "tiny"): PAPER_MOE_TINY,
    ("moe", "base"): PAPER_MOE,
    ("ssm", "tiny"): PAPER_SSM_TINY,
    ("ssm", "base"): PAPER_SSM,
}

ZOO_MODELS = ("transformer", "moe", "ssm")
ZOO_TIERS = ("tiny", "base")


def zoo_config(model: str, tier: str = "tiny") -> ModelConfig:
    try:
        return ZOO[(model, tier)]
    except KeyError:
        raise ValueError(f"unknown zoo config ({model!r}, {tier!r}); "
                         f"models={ZOO_MODELS} tiers={ZOO_TIERS}") from None
