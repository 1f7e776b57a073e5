from repro_torch.optim.optimizer import (OptimizerConfig, init_opt_state,
                                         lr_at, opt_update)  # noqa: F401
