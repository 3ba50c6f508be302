"""Placement rules and the activation-sharding context (port of
``repro.sharding``)."""
from repro_torch.sharding.ctx import (activation_sharding, constrain,
                                      current_tp, tensor_parallel)
from repro_torch.sharding import rules  # noqa: F401

__all__ = ["constrain", "activation_sharding", "tensor_parallel",
           "current_tp", "rules"]
