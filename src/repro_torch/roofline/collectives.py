"""Collective-byte accounting of the port's mesh programs.

The twin of ``repro.roofline.hlo_collectives``.  ``repro`` parses the
collectives out of its compiled HLO; the port's traffic between mesh
positions is explicit in Python, so the places that move data between
positions report it here while :func:`collective_bytes` counts:

* an all-gather where a split tensor is joined: ``Sharded.split``'s FSDP
  gather over the data axes, ``Split.full``, ``Sharded.gather`` and the
  head's concatenation of the vocab-split logits;
* an all-reduce where positions' partial results are summed: the float32
  partial products of the head- and column-split layers
  (``common.sum_partials``), the vocab-split embedding lookups, and the
  gradients of positions that hold the same slice (``reduce_grads``);
* a reduce-scatter where FSDP's gradients are reduced onto their shards
  (``reduce_grads`` of a leaf split over the data axes).

Each collective counts ``repro``'s operand size, per taking-part position,
summed over the positions (``repro`` counts one position's program and
multiplies by the chips; the port's count is over the whole mesh already):

    all-reduce     : each position's operand (its partial, or its gradient)
    all-gather     : each position's shard, so the whole tensor once
    reduce-scatter : each position's operand, the unscattered gradient

With no count running a report costs one test of an empty list, and the
programs' numerics are untouched either way: a report reads shapes only.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

_ACTIVE: list = []


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def record(kind: str, n: int) -> None:
    """Add ``n`` operand bytes of a ``kind`` collective to the innermost
    running count (no-op when none runs)."""
    if _ACTIVE:
        _ACTIVE[-1][kind] += int(n)


@contextlib.contextmanager
def collective_bytes():
    """Count the collectives of everything run inside, in every thread
    (autograd runs remat's recomputations on its own).  Yields a dict that
    is filled on exit in ``repro``'s form: ``{op_kind: operand_bytes}``
    plus ``{"total": sum}``."""
    counts: dict = defaultdict(int)
    _ACTIVE.append(counts)
    out: dict = {}
    try:
        yield out
    finally:
        _ACTIVE[:] = [c for c in _ACTIVE if c is not counts]
        out.update({k: int(v) for k, v in counts.items()})
        out["total"] = sum(counts.values())
