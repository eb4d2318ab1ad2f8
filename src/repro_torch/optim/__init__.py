from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, clip_by_global_norm, sgd)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, linear_warmup)
