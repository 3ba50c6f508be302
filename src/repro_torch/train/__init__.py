from repro_torch.train.trainer import (TrainLog, make_loss_and_grad,
                                       make_step_core, make_train_step, train)

__all__ = ["TrainLog", "make_loss_and_grad", "make_step_core",
           "make_train_step", "train"]
