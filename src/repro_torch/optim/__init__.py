from repro_torch.optim.adam import (AdamConfig, apply_updates, clip_by_global_norm,
                                    global_norm, init_state, schedule)

__all__ = ["AdamConfig", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_state", "schedule"]
