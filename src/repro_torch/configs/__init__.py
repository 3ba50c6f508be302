from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      LONG_CONTEXT_ARCHS, InputShape,
                                      ModelConfig, get_config,
                                      shape_applicable)
from repro_torch.configs.paper_cnns import (ALEXNET_SMALL, CIFAR_QUICK, LENET,
                                            PAPER_CNNS, CNNConfig, ConvSpec)
from repro_torch.configs.paper_transformer import (PAPER_MOE, PAPER_MOE_TINY,
                                                   PAPER_SSM, PAPER_SSM_TINY,
                                                   PAPER_TRANSFORMER,
                                                   PAPER_TRANSFORMER_TINY, ZOO,
                                                   ZOO_MODELS, ZOO_TIERS,
                                                   zoo_config)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_ARCHS", "InputShape",
           "ModelConfig", "get_config", "shape_applicable", "ALEXNET_SMALL",
           "CIFAR_QUICK", "LENET", "PAPER_CNNS", "CNNConfig", "ConvSpec",
           "PAPER_MOE", "PAPER_MOE_TINY", "PAPER_SSM", "PAPER_SSM_TINY",
           "PAPER_TRANSFORMER", "PAPER_TRANSFORMER_TINY", "ZOO", "ZOO_MODELS",
           "ZOO_TIERS", "zoo_config"]
