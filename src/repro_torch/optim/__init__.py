"""Optimizers: the twins of ``repro.optim`` (AdamW, EigenPre, schedules)."""

from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.eigenpre import EigenPre, EigenPreState  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
