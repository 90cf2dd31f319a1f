"""Single-process training: AdamW, the train and eval steps, checkpoints.
The JAX package's ``repro.train`` at world size 1 (its sharded step,
ZeRO flat shards, FSDP leaves and gradient compression need ranks)."""
from repro_torch.train.optimizer import OptConfig, schedule_lr  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    init_state,
    make_eval_step,
    make_train_step,
    state_from_params,
)
from repro_torch.train import checkpoint  # noqa: F401
