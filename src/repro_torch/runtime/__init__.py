"""Serving-runtime support: deterministic fault injection and retry
backoff (the ported part of ``repro.runtime``)."""

from repro_torch.runtime.chaos import (  # noqa: F401
    ChaosConfig,
    ChaosError,
    ChaosFailure,
    ChaosMonkey,
)
from repro_torch.runtime.fault_tolerance import decorrelated_jitter  # noqa: F401
