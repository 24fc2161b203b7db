"""Optimizer and learning-rate schedules (counterpart of ``repro.optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "wsd_schedule"]
