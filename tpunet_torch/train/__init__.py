"""tpunet_torch.train — the data-parallel training step (replicated, or
ZeRO-1 with the optimizer state sharded over the DCN world) for the
Transformer and VGG families, its optimizers (adamw, sgd), loop and
checkpoints, the synthetic image batches, and elastic recovery: a job that
loses a rank rebuilds its communicator at a new generation and resumes
from a checkpoint (``run_elastic``). The port of ``tpunet.train``."""

from tpunet_torch.train.checkpoint import (CheckpointManager,
                                           StepAlreadyExistsError,
                                           restore_pytree, save_pytree)
from tpunet_torch.train.elastic import (ExcludedFromMembership,
                                        is_comm_failure, read_generation,
                                        run_elastic, write_generation)
from tpunet_torch.train.fit import fit
from tpunet_torch.train.trainer import (TrainState, adamw,
                                        create_train_state,
                                        create_zero_train_state,
                                        make_train_step,
                                        make_zero_train_step, sgd,
                                        synthetic_batch)

__all__ = ["CheckpointManager", "ExcludedFromMembership",
           "StepAlreadyExistsError", "TrainState", "adamw",
           "create_train_state", "create_zero_train_state", "fit",
           "is_comm_failure", "make_train_step", "make_zero_train_step",
           "read_generation", "restore_pytree", "run_elastic", "save_pytree",
           "sgd", "synthetic_batch", "write_generation"]
