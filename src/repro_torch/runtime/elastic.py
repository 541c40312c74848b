"""Rendezvous routing for the replica fleet.

The port's part of ``repro.runtime.elastic``: only :func:`route_key`, the
hash ``engine.fleet`` routes requests and sessions with.  The mesh helpers
of ``repro``'s module (``best_grid``, ``make_elastic_mesh``,
``reshard_state``) belong to the sharded backend, which is not ported.
"""

from __future__ import annotations

import zlib


def route_key(key, candidates, salt: int = 0):
    """Rendezvous (highest-random-weight) hash: pick one of ``candidates``
    for ``key``.

    Each ``(key, candidate)`` pair gets an independent deterministic score;
    the winner is the max.  Properties the fleet router leans on:

    * removing a candidate remaps only the keys it owned (minimal churn on
      replica death), and restoring it returns exactly those keys (routing
      self-heals after restart, no table to rebuild);
    * pure function of ``(key, candidate, salt)`` — identical across
      processes, runs and both packages, so tests can predict placement.

    ``candidates`` must be non-empty; candidates and ``key`` need stable
    ``repr``s (ints / strings / tuples thereof).
    """
    if not candidates:
        raise ValueError("route_key: no candidates")

    def score(c) -> int:
        # crc32 alone is GF(2)-linear: a salt change would XOR every
        # candidate's score by the *same* constant (same-length reprs) and
        # barely reshuffle ownership.  Fold the salt in through an
        # avalanche mix (finalizer-style) so distinct salts give
        # independent placements.
        h = zlib.crc32(repr((key, c)).encode())
        h = (h + 0x9E3779B9 * (salt + 1)) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h ^= h >> 16
        return h

    return max(candidates, key=score)
