"""Tensors held as shards on a mesh (the port's counterpart of
``jax.device_put`` with a ``NamedSharding``).

A :class:`Sharded` tensor keeps one shard per mesh position ``(r, m)``
(data row ``r``, model column ``m``) on that position's device.  Its spec
(``rules.P``) splits each dimension mapped to ``data`` over the data axis
and each mapped to ``model`` over the model axis; an unmapped dimension is
whole in every shard, so the shards of a replicated tensor are copies.  The
bytes each position holds are exactly what ``repro``'s spec gives on that
mesh (:func:`device_bytes`).  On a logical mesh that repeats one device,
every position's shard is its own tensor all the same.

The mesh programs (``train.steps.build_programs``) read a tensor a row at
a time: :meth:`Sharded.split` gives row ``r``'s model-axis parts as a
:class:`Split`, each part on its own device with the data axis gathered
onto it (FSDP's all-gather; a no-op under the TP rules).  Gradients of the
shards are summed over the positions that hold the same slice
(:func:`reduce_grads`, the all-reduce), in row-major position order.

A :class:`Sharding` with spec None places a tensor whole on the mesh's
first device (``EigenPre``'s grams); a 0-d tensor stays where it is (the
port's step counters are host scalars).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.sharding.rules import P


@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding``'s stand-in: a mesh and a spec (None: whole on the
    mesh's first device)."""

    mesh: object
    spec: P | None


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Split(NamedTuple):
    """One data row's view of a tensor: a part per model column (part ``m``
    on the row's device ``m``), split along ``dim``, or, with ``dim`` None,
    each part the whole tensor."""

    parts: tuple
    dim: int | None

    def full(self) -> torch.Tensor:
        """The whole tensor on the first part's device."""
        if self.dim is None or len(self.parts) == 1:
            return self.parts[0]
        dev = self.parts[0].device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.dim)

    def bounds(self, m: int) -> tuple:
        """``[lo, hi)`` of part ``m`` along ``dim``."""
        n = self.parts[m].shape[self.dim]
        return m * n, (m + 1) * n

    def write(self, value: torch.Tensor, dim: int = 0, start: int = 0):
        """Write ``value``, the whole tensor's region ``[start, start +
        value.shape[dim])`` along ``dim`` (whole along every other
        dimension), into the parts that hold it."""
        length = value.shape[dim]
        for m, part in enumerate(self.parts):
            if self.dim is None:
                part.narrow(dim, start, length).copy_(value)
                continue
            lo, hi = self.bounds(m)
            if self.dim == dim:
                a, b = max(lo, start), min(hi, start + length)
                if a < b:
                    part.narrow(dim, a - lo, b - a).copy_(
                        value.narrow(dim, a - start, b - a))
            else:
                part.narrow(dim, start, length).copy_(
                    value.narrow(self.dim, lo, hi - lo))


class Sharded:
    """A tensor of ``shape`` held as ``shards[r][m]`` on a mesh by
    ``spec``."""

    __slots__ = ("shards", "spec", "mesh", "shape")

    def __init__(self, shards, spec: P, mesh, shape):
        self.shards = tuple(tuple(row) for row in shards)
        self.spec = P(*spec, *([None] * (len(shape) - len(spec))))
        self.mesh = mesh
        self.shape = tuple(shape)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype})")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][0].dtype

    @property
    def sharding(self) -> Sharding:
        return Sharding(self.mesh, self.spec)

    def _dim_of(self, axis: str) -> int | None:
        for i, e in enumerate(self.spec):
            if axis in _names(e):
                return i
        return None

    def map(self, fn) -> "Sharded":
        """``fn`` on every shard (same spec)."""
        return Sharded([[fn(t) for t in row] for row in self.shards],
                       self.spec, self.mesh, self.shape)

    def unbind(self) -> list:
        """Per-row views along dimension 0 (never sharded: the stacked
        ``layers`` axis), each unbound once per shard."""
        if self.spec[0] is not None:
            raise ValueError(f"unbind of a tensor split on dimension 0: "
                             f"{self.spec}")
        rows = [[torch.unbind(t) for t in row] for row in self.shards]
        spec = P(*self.spec[1:])
        return [Sharded([[t[i] for t in row] for row in rows], spec,
                        self.mesh, self.shape[1:])
                for i in range(self.shape[0])]

    def split(self, r: int, gather_data: bool = True) -> Split:
        """Row ``r``'s parts.  With ``gather_data``, a dimension split over
        ``data`` is gathered from every row onto each part's device (FSDP);
        without, each part is the row's own shard (a cache's batch rows)."""
        ddim = self._dim_of("data")
        mdim = self._dim_of("model")
        if ddim is not None and ddim == mdim:
            raise ValueError(f"a dimension split over both axes: {self.spec}")
        devices = self.mesh.devices[r]
        parts = []
        for m, dev in enumerate(devices):
            if ddim is None or not gather_data:
                parts.append(self.shards[r][m])
            else:
                parts.append(torch.cat(
                    [self.shards[rr][m].to(dev) for rr in range(len(self.shards))],
                    dim=ddim))
        return Split(tuple(parts), mdim)

    def slice_key(self, r: int, m: int) -> tuple:
        """Which slice position ``(r, m)`` holds: positions with equal keys
        hold the same values."""
        return tuple(_index(e, self.mesh, r, m) for e in self.spec)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first)."""
        device = torch.device(device) if device is not None else (
            self.mesh.first_device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for r, row in enumerate(self.shards):
            for m, t in enumerate(row):
                out[_slices(self.spec, self.mesh, self.shape, r, m)] = t.to(
                    device)
        return out


def _axis_size(mesh, entry) -> int:
    shape = dict(mesh.shape)
    size = 1
    for a in _names(entry):
        size *= shape[a]
    return size


def _index(entry, mesh, r: int, m: int) -> int:
    """The shard index along a dimension of ``entry`` at position
    ``(r, m)``."""
    pos = {mesh.axis_names[0]: r, mesh.axis_names[1]: m}
    shape = dict(mesh.shape)
    idx = 0
    for a in _names(entry):
        idx = idx * shape[a] + pos[a]
    return idx


def _slices(spec, mesh, shape, r: int, m: int) -> tuple:
    out = []
    for e, n in zip(spec, shape):
        k = _axis_size(mesh, e)
        if n % k:
            raise ValueError(f"dimension {n} does not split over {e!r} of "
                             f"size {k}")
        i = _index(e, mesh, r, m)
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def put(x: torch.Tensor, sharding: Sharding):
    """``x`` placed by ``sharding``: a :class:`Sharded` whose shards are
    copies of ``x``'s slices on each position's device; with spec None a
    tensor on the mesh's first device; a 0-d tensor as it is."""
    if isinstance(x, Sharded):
        x = x.gather()
    if sharding.spec is None:
        return x.to(sharding.mesh.first_device)
    if x.dim() == 0:
        return x
    mesh = sharding.mesh
    shards = [[x[_slices(sharding.spec, mesh, x.shape, r, m)].to(
                   dev, copy=True)
               for m, dev in enumerate(row)]
              for r, row in enumerate(mesh.devices)]
    return Sharded(shards, sharding.spec, mesh, x.shape)


def zeros(shape, dtype, sharding: Sharding) -> Sharded:
    """A zero :class:`Sharded` of ``shape``, each shard allocated at its own
    size."""
    mesh = sharding.mesh
    spec = P(*sharding.spec, *([None] * (len(shape) - len(sharding.spec))))
    local = [n // _axis_size(mesh, e) for e, n in zip(spec, shape)]
    for e, n in zip(spec, shape):
        if n % _axis_size(mesh, e):
            raise ValueError(f"dimension {n} does not split over {e!r}")
    return Sharded([[torch.zeros(local, dtype=dtype, device=dev) for dev in row]
                    for row in mesh.devices], spec, mesh, shape)


# -- trees ----------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of dicts, lists, tuples and named tuples
    (``rest`` of the same structure); a :class:`P`, a :class:`Sharding` and
    whatever ``is_leaf`` accepts are leaves."""
    if (is_leaf is not None and is_leaf(tree)) or isinstance(
            tree, (P, Sharding, Sharded)) or tree is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(o[i] for o in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(o[i] for o in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def put_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the leaf of ``shardings`` at the
    same path (``jax.device_put(tree, shardings)``)."""
    return tree_map(lambda s, x: None if x is None else put(x, s),
                    shardings, tree)


def shardings_of(mesh, spec_tree):
    """A :class:`Sharding` per spec leaf (``repro``'s ``_named``)."""
    return tree_map(lambda s: Sharding(mesh, s), spec_tree)


def device_bytes(tree, mesh) -> list:
    """Bytes each mesh position holds, ``[r][m]``: the shards of every
    :class:`Sharded` leaf, and every other tensor on the first position."""
    out = [[0] * len(mesh.devices[0]) for _ in mesh.devices]

    def add(x):
        if isinstance(x, Sharded):
            for r, row in enumerate(x.shards):
                for m, t in enumerate(row):
                    out[r][m] += t.numel() * t.element_size()
        elif isinstance(x, torch.Tensor) and x.dim() > 0:
            out[0][0] += x.numel() * x.element_size()
        return x

    tree_map(add, tree)
    return out


# -- gradients ------------------------------------------------------------------


def groups(x: Sharded) -> list:
    """The positions of ``x`` grouped by the slice they hold, each group in
    row-major order and the groups in the order of their first position."""
    by_key: dict = {}
    for r, row in enumerate(x.shards):
        for m, _ in enumerate(row):
            by_key.setdefault(x.slice_key(r, m), []).append((r, m))
    return list(by_key.values())


def reduce_grads(leaves: Sharded, scale: float = 1.0) -> Sharded:
    """The all-reduce of a sharded leaf's gradients: each position gets
    the sum, in row-major order, of the ``.grad``s of every position that
    holds its slice (a missing grad counts as zero), times ``scale``.  A
    position on the device of the sum shares its tensor."""
    out = [[None] * len(row) for row in leaves.shards]
    for group in groups(leaves):
        total = None
        for r, m in group:
            g = leaves.shards[r][m].grad
            if g is None:
                continue
            total = g if total is None else total + g.to(total.device)
        if total is None:
            total = torch.zeros_like(leaves.shards[group[0][0]][group[0][1]])
        elif scale != 1.0:
            total = total * scale
        for r, m in group:
            dev = leaves.mesh.devices[r][m]
            out[r][m] = total if total.device == dev else total.to(dev)
    return Sharded(out, leaves.spec, leaves.mesh, leaves.shape)


def distinct(x: Sharded) -> list:
    """One shard per distinct slice, in :func:`groups` order."""
    return [x.shards[g[0][0]][g[0][1]] for g in groups(x)]
