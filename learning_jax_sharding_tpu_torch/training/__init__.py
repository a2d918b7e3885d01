"""Train state, train step, eval step and apply function; the optimizer
wrappers (fp32 masters, the parameter EMA, ZeRO-1); LoRA; the training
loop and checkpoints (``training.loop``, ``training.checkpoint``)."""

from learning_jax_sharding_tpu_torch.training.pipeline import (  # noqa: F401
    TrainState,
    make_apply_fn,
    make_eval_step,
    make_train_step,
    sharded_train_state,
)
from learning_jax_sharding_tpu_torch.training.ema import (  # noqa: F401
    EmaState,
    ema_params,
    with_ema,
)
from learning_jax_sharding_tpu_torch.training.lora import (  # noqa: F401
    LoraState,
    init_lora,
    lora_shardings,
    lora_train_state,
    make_lora_train_step,
    merge_lora,
)
from learning_jax_sharding_tpu_torch.training.precision import (  # noqa: F401
    MasterWeightsState,
    master_weights,
)
from learning_jax_sharding_tpu_torch.training.zero import (  # noqa: F401
    make_zero1_update,
    zero1_shardings,
)
from learning_jax_sharding_tpu_torch.training.checkpoint import CheckpointManager  # noqa: F401
