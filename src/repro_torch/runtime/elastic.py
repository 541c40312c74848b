"""Rendezvous routing for the replica fleet, and elastic meshes.

The port's part of ``repro.runtime.elastic``: :func:`route_key`, the hash
``engine.fleet`` routes requests and sessions with, and the mesh helpers
:func:`best_grid` and :func:`make_elastic_mesh`, which rebuild a mesh from
the devices that survive, and :func:`reshard_state`, which restores a
training checkpoint onto the new mesh.
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


def best_grid(n_devices: int, model_parallel: int) -> tuple:
    """Largest ``(data, model)`` grid with the model axis at the requested
    degree.

    Shrinks the model axis by powers of two where the device count cannot
    sustain it (12 survivors of a 16-wide job: ``(3, 4)`` ... ``(12, 1)``).
    """
    tp = model_parallel
    while tp > 1 and n_devices % tp:
        tp //= 2
    return max(n_devices // tp, 1), tp


def make_elastic_mesh(model_parallel: int, devices=None):
    """The :func:`best_grid` mesh over ``devices`` (default: every card)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh

    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    data, model = best_grid(len(devices), model_parallel)
    return make_local_mesh(data, model, devices=devices)


def reshard_state(manager, abstract_state, mesh, model, fsdp=None, step=None):
    """Restore the latest checkpoint (or ``step``) onto ``mesh`` (any size):
    ``repro``'s, with the optimizer state's specs taken from
    ``abstract_state``'s kind (AdamW's, or ``EigenPre``'s grams whole on the
    mesh's first device).  ``fsdp`` None decides as ``build_programs``
    does.  Returns (state, extra)."""
    from repro_torch.sharding import placement
    from repro_torch.sharding import rules as rules_lib
    from repro_torch.train import steps as steps_lib

    if fsdp is None:
        fsdp = rules_lib.fsdp_recommended(model.n_params(), mesh,
                                          rules_lib.chip_memory(mesh))
    rules = rules_lib.make_rules(mesh, fsdp=fsdp)
    ps = steps_lib.param_pspecs(model, rules)
    specs = steps_lib.TrainState(
        ps, steps_lib.optimizer_state_pspecs(abstract_state.opt_state, ps),
        rules_lib.P())
    return manager.restore(abstract_state, step=step,
                           shardings=placement.shardings_of(mesh, specs))
