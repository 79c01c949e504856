from repro_torch.optim.adam import AdamConfig, apply_updates, clip_by_global_norm, global_norm, init_opt_state
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamConfig", "init_opt_state", "apply_updates", "global_norm",
    "clip_by_global_norm", "warmup_cosine",
]
