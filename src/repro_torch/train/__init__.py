"""Training: AdamW, the train and eval steps of one rank of a (pod, data,
model) grid (the JAX package's ``repro.train``: ZeRO flat state, FSDP
leaves, int8 pod compression, the sharded step), checkpoints."""
from repro_torch.train.optimizer import OptConfig, schedule_lr  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    init_state,
    make_eval_step,
    make_sharded_train_step,
    make_train_step,
    state_from_params,
)
from repro_torch.train import checkpoint  # noqa: F401
