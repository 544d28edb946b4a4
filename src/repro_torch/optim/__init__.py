"""Optimizers and learning-rate schedules on dicts of tensors: the
reference's ``repro/optim`` (an ``(init, update)`` pair per optimizer,
updates added to the parameters by ``apply_updates``)."""

from .optimizers import (
    OptState,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd,
)
from .schedule import constant, cosine_decay, linear_warmup_cosine, warmup_constant

__all__ = [
    "OptState",
    "Optimizer",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "sgd",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
    "warmup_constant",
]
