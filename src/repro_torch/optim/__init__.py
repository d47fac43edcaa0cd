from repro_torch.optim.optimizer import (
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    make_optimizer,
    momentum,
    sgd,
)

__all__ = [
    "make_optimizer", "sgd", "momentum", "adam", "adamw", "apply_updates",
    "cosine_schedule", "linear_warmup_cosine",
    "clip_by_global_norm", "global_norm",
]
