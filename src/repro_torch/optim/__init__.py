from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_pspecs,
                                     adamw_update, cosine_schedule,
                                     global_norm, global_norm_clip)

__all__ = ["AdamWState", "adamw_init", "adamw_pspecs", "adamw_update",
           "cosine_schedule", "global_norm", "global_norm_clip"]
