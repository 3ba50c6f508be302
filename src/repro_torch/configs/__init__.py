from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_transformer import (PAPER_SSM, PAPER_SSM_TINY,
                                                   PAPER_TRANSFORMER,
                                                   PAPER_TRANSFORMER_TINY, ZOO,
                                                   ZOO_MODELS, ZOO_TIERS,
                                                   zoo_config)

__all__ = ["ModelConfig", "PAPER_SSM", "PAPER_SSM_TINY", "PAPER_TRANSFORMER",
           "PAPER_TRANSFORMER_TINY", "ZOO", "ZOO_MODELS", "ZOO_TIERS",
           "zoo_config"]
