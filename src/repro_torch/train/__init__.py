from repro_torch.train.chunked import (ChunkFn, chunk_over_ring,
                                       make_chunked_train_step,
                                       make_device_step)
from repro_torch.train.trainer import (TrainLog, host_metrics,
                                       make_loss_and_grad,
                                       make_scheduled_train_step,
                                       make_step_core, make_train_step, train)

__all__ = ["ChunkFn", "chunk_over_ring", "make_chunked_train_step",
           "make_device_step", "TrainLog", "host_metrics",
           "make_loss_and_grad", "make_scheduled_train_step",
           "make_step_core", "make_train_step", "train"]
