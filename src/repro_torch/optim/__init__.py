from repro_torch.optim.optimizers import (adam, adamw, sgd, Optimizer,
                                          cosine_schedule, constant_schedule,
                                          linear_warmup_cosine,
                                          clip_by_global_norm, global_norm)

__all__ = ["adam", "adamw", "sgd", "Optimizer", "cosine_schedule",
           "constant_schedule", "linear_warmup_cosine",
           "clip_by_global_norm", "global_norm"]
