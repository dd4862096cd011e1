"""AdamW with the reference's mixed-precision policy, updating in place."""

from repro_torch.optim.optimizer import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
)
