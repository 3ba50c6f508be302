from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_cnns import (ALEXNET_SMALL, CIFAR_QUICK, LENET,
                                            PAPER_CNNS, CNNConfig, ConvSpec)
from repro_torch.configs.paper_transformer import (PAPER_SSM, PAPER_SSM_TINY,
                                                   PAPER_TRANSFORMER,
                                                   PAPER_TRANSFORMER_TINY, ZOO,
                                                   ZOO_MODELS, ZOO_TIERS,
                                                   zoo_config)

__all__ = ["ModelConfig", "ALEXNET_SMALL", "CIFAR_QUICK", "LENET",
           "PAPER_CNNS", "CNNConfig", "ConvSpec", "PAPER_SSM",
           "PAPER_SSM_TINY", "PAPER_TRANSFORMER", "PAPER_TRANSFORMER_TINY",
           "ZOO", "ZOO_MODELS", "ZOO_TIERS", "zoo_config"]
