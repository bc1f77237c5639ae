from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     clip_by_global_norm, global_norm,
                                     init_opt)
from repro_torch.optim.schedule import SCHEDULES, warmup_cosine

__all__ = ["OptConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_opt", "SCHEDULES", "warmup_cosine"]
