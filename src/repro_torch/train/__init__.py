"""Training of the port (``repro_torch.train``), the counterpart of
``repro.train``: the train step and its captured process, and the
fault-tolerant trainer."""
from .step import (
    TrainConfig,
    TrainProcess,
    batch_pspecs,
    init_ef_buffers,
    init_mesh_state,
    make_train_state,
    make_mesh_train_step,
    make_train_step,
    shard_state,
    state_pspecs,
    to_named,
)
from .trainer import StepTimeout, Trainer, TrainerConfig

__all__ = ["StepTimeout", "TrainConfig", "TrainProcess", "Trainer", "TrainerConfig",
           "batch_pspecs", "init_ef_buffers", "init_mesh_state", "make_mesh_train_step",
           "make_train_state", "make_train_step", "shard_state", "state_pspecs", "to_named"]
