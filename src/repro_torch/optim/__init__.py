from repro_torch.optim.base import (RULES, UpdateRule, adagrad, adam,
                                    momentum, nesterov, sgd)

__all__ = ["RULES", "UpdateRule", "adagrad", "adam", "momentum", "nesterov",
           "sgd"]
