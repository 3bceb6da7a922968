"""Functional optimizers over param trees (see ``optimizers``)."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw, apply_updates,
                                          clip_by_global_norm,
                                          clip_by_global_norm_, global_norm,
                                          sgd_momentum, warmup_cosine)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates", "clip_by_global_norm",
           "clip_by_global_norm_", "global_norm", "sgd_momentum",
           "warmup_cosine"]
