"""Activation-sharding hints for model internals, the twin of
``repro.sharding.hints``.

``repro``'s model code pins some intermediate layouts with
``with_sharding_constraint`` (the MoE's dispatch tensors, the attention's
q/k/v).  Hints are process-local context, set by ``train.steps.
build_programs`` around each program; when unset, constraints are no-ops.

The port's mesh programs lay their tensors out explicitly
(``sharding.placement``), so a layout request has no numeric effect here:
:func:`constrain` returns its input unchanged.  Under active hints it
records the mapped spec in ``current()["requests"]``, so that a test can
hold the model's requests to ``repro``'s.
"""

from __future__ import annotations

import contextlib
import contextvars

from repro_torch.sharding.rules import P

_HINTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sharding_hints", default=None)


@contextlib.contextmanager
def axis_hints(data=None, model=None, model_size: int = 1):
    """Declare mesh axis names (+ model-axis size) for activation
    constraints."""
    token = _HINTS.set({"data": data, "model": model,
                        "model_size": model_size, "requests": []})
    try:
        yield
    finally:
        _HINTS.reset(token)


@contextlib.contextmanager
def paused():
    """No hints inside (a mesh program's per-shard call of an unsharded
    function, whose requests would name the shard's layout as the
    whole's)."""
    token = _HINTS.set(None)
    try:
        yield
    finally:
        _HINTS.reset(token)


def current() -> dict | None:
    return _HINTS.get()


def model_axis_size() -> int:
    hints = _HINTS.get()
    return hints.get("model_size", 1) if hints else 1


def constrain(x, *axes):
    """Record ``P(*mapped_axes)`` under active hints and return ``x``.

    ``axes`` entries are "data" / "model" / None, mapped through the hint
    table; nothing is recorded when hints are absent or every entry maps to
    None (``repro``'s no-op cases).
    """
    hints = _HINTS.get()
    if hints is None:
        return x
    mapped = tuple(hints.get(a) if isinstance(a, str) else a for a in axes)
    if all(m is None for m in mapped):
        return x
    hints["requests"].append(P(*mapped))
    return x
