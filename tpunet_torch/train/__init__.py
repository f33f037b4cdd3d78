"""tpunet_torch.train — the data-parallel training step (replicated, or
ZeRO-1 with the optimizer state sharded over the DCN world) for the
Transformer and VGG families, its optimizers (adamw, sgd), loop and
checkpoints, and the synthetic image batches (the port of
``tpunet.train`` without elastic training, a later slice)."""

from tpunet_torch.train.checkpoint import (CheckpointManager,
                                           StepAlreadyExistsError,
                                           restore_pytree, save_pytree)
from tpunet_torch.train.fit import fit
from tpunet_torch.train.trainer import (TrainState, adamw,
                                        create_train_state,
                                        create_zero_train_state,
                                        make_train_step,
                                        make_zero_train_step, sgd,
                                        synthetic_batch)

__all__ = ["CheckpointManager", "StepAlreadyExistsError", "TrainState",
           "adamw", "create_train_state", "create_zero_train_state", "fit",
           "make_train_step", "make_zero_train_step", "restore_pytree",
           "save_pytree", "sgd", "synthetic_batch"]
