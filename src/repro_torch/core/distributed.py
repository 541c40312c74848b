"""Distributed EEI: the ``sharded`` backend and the minor and term axes.

The twin of ``repro.core.distributed`` on a :class:`~repro_torch.launch.
mesh.Mesh`.  Three axes, composable:

* the **batch axis** (the mesh's data axis): the matrix stack is split,
  and each device runs every stage on its slice of the stack.  No
  collectives; this is the serving axis the engine and the server pad
  stacks for (``make_sharded_backend``).
* the **minor axis** (components ``j``, the model axis): each device takes
  a block of minors, their spectra and its column block of ``|v[i, j]|^2``
  (``minor_sharded_magnitudes``).
* the **term axis** (product terms ``k``): each device log-reduces a
  contiguous batch of eigenvalue-difference terms, and one sum joins them:
  Algorithm 2's dispatch / join (lines 9-15) with batch boundary = shard
  boundary (``term_sharded_component``).

``repro`` runs these under ``shard_map`` from one controller.  So does the
port: one process issues every shard, from one host thread in device
order, each on its shard's device, and gathers the results on the mesh's
first device (where ``repro``'s ``psum`` leaves a replicated value, the
port leaves it on that device).  Shards on one device (a repeated device)
run one after the other.
"""

from __future__ import annotations

import torch

from repro_torch.core import identity, minors
from repro_torch.engine.plan import SolverPlan
from repro_torch.engine.registry import StageLibrary

# ---------------------------------------------------------------------------
# Sharded backend: batch axis = data axis
# ---------------------------------------------------------------------------


def _gather(outs, first: torch.device):
    """Per-shard outputs (tensors or tuples of tensors) joined along the
    batch axis on ``first``.  One shard's output is returned as it is."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([p.to(first) for p in parts])
                     for parts in zip(*outs))
    return torch.cat([o.to(first) for o in outs])


def make_sharded_backend(plan: SolverPlan) -> StageLibrary:
    """Stage library running the ``cuda`` library's stages shard by shard.

    Every stage splits its leading batch axis over ``plan.batch_axis``; the
    pipeline is batch-parallel, so nothing crosses shards until the outputs
    are gathered.  The engine keeps the stack divisible by padding it.
    Inputs of rank ``"r1"`` (the windowed ``idx``) go whole to every shard.
    ``repro`` wraps its ``jnp`` library; the port wraps ``cuda``, whose
    stages run the kernels on the card (on CPU tensors: their plain
    versions, the ``torch`` library's arithmetic).
    """
    from repro_torch.engine.backends import make_cuda_backend

    inner = make_cuda_backend(plan)
    devices = plan.mesh.axis_devices(plan.batch_axis)
    first = plan.mesh.first_device

    def shard(fn, in_ranks):
        def run(*args):
            b = args[0].shape[0]
            if b % len(devices):
                raise ValueError(
                    f"a stack of {b} does not split over the "
                    f"{plan.batch_axis!r} axis of {len(devices)} devices")
            size = b // len(devices)
            outs = []
            for s, dev in enumerate(devices):
                part = [x if rank == "r1" else x[s * size:(s + 1) * size]
                        for x, rank in zip(args, in_ranks)]
                outs.append(fn(*(x.to(dev) for x in part)))
            return _gather(outs, first)

        return run

    def tridiagonalize(a, with_q=True):
        if with_q:
            return shard(lambda x: inner.tridiagonalize(x, True), (3,))(a)
        d, e = shard(lambda x: inner.tridiagonalize(x, False)[:2], (3,))(a)
        return d, e, None

    def tridiag_eigenvalues_windowed(d, e, k, largest):
        return shard(lambda dd, ee: inner.tridiag_eigenvalues_windowed(
            dd, ee, k, largest), (2, 2))(d, e)

    def tridiag_eigenvalues_bracketed(d, e, lo, hi, k, largest):
        def bracketed(dd, ee, ll, hh):
            return inner.tridiag_eigenvalues_bracketed(dd, ee, ll, hh, k,
                                                       largest)

        return shard(bracketed, (2, 2, 2, 2))(d, e, lo, hi)

    def krylov_reduce(a, k, largest):
        return shard(lambda x: inner.krylov_reduce(x, k, largest), (3,))(a)

    def krylov_shift_invert_reduce(a, k, largest):
        return shard(lambda x: inner.krylov_shift_invert_reduce(
            x, k, largest), (3,))(a)

    return StageLibrary("sharded", {
        "tridiagonalize": tridiagonalize,
        "tridiag_eigenvalues": shard(inner.tridiag_eigenvalues, (2, 2)),
        "tridiag_eigenvalues_windowed": tridiag_eigenvalues_windowed,
        "tridiag_eigenvalues_bracketed": tridiag_eigenvalues_bracketed,
        "tridiag_minor_spectra": shard(inner.tridiag_minor_spectra, (2, 2)),
        "dense_eigenvalues": shard(inner.dense_eigenvalues, (3,)),
        "dense_minor_spectra": shard(inner.dense_minor_spectra, (3,)),
        "magnitudes": shard(inner.magnitudes, (2, 3)),
        "magnitudes_windowed": shard(inner.magnitudes_windowed,
                                     (2, 3, "r1")),
        "minor_det_components": shard(inner.minor_det_components,
                                      (2, 2, 2)),
        "tridiag_signs": shard(inner.tridiag_signs, (2, 2, 2, 3)),
        "dense_signs": shard(inner.dense_signs, (3, 2, 3)),
        "krylov_reduce": krylov_reduce,
        "krylov_shift_invert_reduce": krylov_shift_invert_reduce,
        # Element-wise over the batch with nothing across shards: it runs
        # whole on the first device, as repro leaves it to GSPMD.
        "verify_topk": inner.verify_topk,
    })


# ---------------------------------------------------------------------------
# Minor and term axes: one matrix over the devices of one axis
# ---------------------------------------------------------------------------


def minor_sharded_magnitudes(a: torch.Tensor, mesh, axis: str = "model"):
    """All ``|v[i, j]|^2`` of ``a (n, n)`` with the minors split over
    ``axis``: each device computes the spectra of its block of minors and
    its column block of the table.  ``n`` must be divisible by the axis
    size.  Returns the whole ``(n, n)`` table on the mesh's first device.
    """
    from repro_torch.engine.backends import _card_float64

    eigvalsh = _card_float64(torch.linalg.eigvalsh)
    devices = mesh.axis_devices(axis)
    n = a.shape[-1]
    if n % len(devices):
        raise ValueError(f"n={n} does not split over the {axis!r} axis of "
                         f"{len(devices)} devices")
    per = n // len(devices)
    blocks = []
    for s, dev in enumerate(devices):
        a_rep = a.to(dev)
        j_block = torch.arange(s * per, (s + 1) * per, device=dev)
        lam = eigvalsh(a_rep)
        mu = eigvalsh(minors.minor_stack(a_rep, j_block))
        log_num = identity.logabs_numerator(lam, mu)  # (n, per)
        log_den = identity.logabs_denominator(lam)  # (n,)
        blocks.append(torch.exp(log_num - log_den[:, None]))
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([blk.to(mesh.first_device) for blk in blocks], dim=-1)


# The name the table had before the engine existed.
sharded_magnitudes = minor_sharded_magnitudes


def term_sharded_component(lam: torch.Tensor, mu_j: torch.Tensor, i: int,
                           mesh, axis: str = "model") -> torch.Tensor:
    """One component with the product terms split over ``axis``
    (Algorithm 2's dispatch).  ``lam (n,)`` and ``mu_j (n-1,)``; each
    device log-reduces its share of the terms, and the sum of the shares on
    the mesh's first device joins them.  The term vectors are padded with
    1.0 (``log 1 = 0``) to a multiple of the axis size."""
    numer_terms = lam[i] - mu_j
    denom_terms = lam[i] - minors.delete_index(lam, i)
    devices = mesh.axis_devices(axis)
    pad = (-numer_terms.shape[0]) % len(devices)
    if pad:
        ones = torch.ones(pad, dtype=lam.dtype, device=lam.device)
        numer_terms = torch.cat([numer_terms, ones])
        denom_terms = torch.cat([denom_terms, ones])
    per = numer_terms.shape[0] // len(devices)
    total = None
    for s, dev in enumerate(devices):
        nt = numer_terms[s * per:(s + 1) * per].to(dev)
        dt = denom_terms[s * per:(s + 1) * per].to(dev)
        part = (torch.log(nt.abs()).sum()
                - torch.log(dt.abs()).sum()).to(mesh.first_device)
        total = part if total is None else total + part
    return torch.exp(total)
