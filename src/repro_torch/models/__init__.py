from repro_torch.models.api import Model, build_model
from repro_torch.models.cnn import (CNN, cnn_accuracy, cnn_logits, cnn_loss_fn,
                                    init_cnn)

__all__ = ["Model", "build_model", "CNN", "cnn_accuracy", "cnn_logits",
           "cnn_loss_fn", "init_cnn"]
