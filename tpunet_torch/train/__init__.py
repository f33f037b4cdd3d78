"""tpunet_torch.train — the data-parallel training step, its loop and
checkpoints (the port of ``tpunet.train`` without ZeRO and elastic
training, which are later slices)."""

from tpunet_torch.train.checkpoint import (CheckpointManager,
                                           StepAlreadyExistsError)
from tpunet_torch.train.fit import fit
from tpunet_torch.train.trainer import (TrainState, adamw,
                                        create_train_state,
                                        create_zero_train_state,
                                        make_train_step,
                                        make_zero_train_step)

__all__ = ["CheckpointManager", "StepAlreadyExistsError", "TrainState",
           "adamw", "create_train_state", "create_zero_train_state", "fit",
           "make_train_step", "make_zero_train_step"]
