from repro_torch.core import batch_model
from repro_torch.core.control import (LossQueue, control_limit, init_queue,
                                      mean, push, push_at, std)
from repro_torch.core.isgd import (DeviceISGDState, ISGDConfig, ISGDState,
                                   consistent_step, consistent_step_device,
                                   isgd_device_init, isgd_init, isgd_step,
                                   isgd_step_device, run_if, solve_subproblem)
from repro_torch.core.schedule import (ALEXNET_SCHEDULE, constant_lr,
                                       loss_driven_lr)

__all__ = ["LossQueue", "control_limit", "init_queue", "mean", "push",
           "push_at", "std", "DeviceISGDState", "ISGDConfig", "ISGDState",
           "consistent_step", "consistent_step_device", "isgd_device_init",
           "isgd_init", "isgd_step", "isgd_step_device", "run_if",
           "solve_subproblem", "ALEXNET_SCHEDULE",
           "constant_lr", "loss_driven_lr", "batch_model"]
