from repro_torch.core.control import (LossQueue, control_limit, init_queue,
                                      mean, push, push_at, std)
from repro_torch.core.isgd import (ISGDConfig, ISGDState, consistent_step,
                                   isgd_init, isgd_step, solve_subproblem)
from repro_torch.core.schedule import (ALEXNET_SCHEDULE, constant_lr,
                                       loss_driven_lr)

__all__ = ["LossQueue", "control_limit", "init_queue", "mean", "push",
           "push_at", "std", "ISGDConfig", "ISGDState", "consistent_step",
           "isgd_init", "isgd_step", "solve_subproblem", "ALEXNET_SCHEDULE",
           "constant_lr", "loss_driven_lr"]
