from repro_torch.optim.adam import AdamConfig, apply_updates, clip_by_global_norm, global_norm, init_opt_state
from repro_torch.optim.schedule import constant, linear_scaled_lr, warmup_cosine

__all__ = [
    "AdamConfig", "init_opt_state", "apply_updates", "global_norm",
    "clip_by_global_norm", "constant", "linear_scaled_lr", "warmup_cosine",
]
