"""Checkpoint manager: async atomic saves, keep-K, restore onto a template.

The twin of ``repro.checkpoint.manager``, in its format: one directory per
step holding ``manifest.json`` (the flattened tree paths, the tree's
structure, the caller's ``extra``) and one ``.npy`` per leaf, numbered in
sorted key order.  A key is ``repro``'s path string: ``k:<dict key>``,
``a:<field>`` of a named tuple, ``i:<index>`` of a list or tuple, joined
by ``§`` (``a:opt_state§a:m§k:embed/tokens``), so either package restores
the other's checkpoints of the same tree.  Leaves are written whole, as
numpy; bfloat16 (which numpy lacks) is widened to float32, losslessly,
and narrowed back on restore by the template leaf's dtype.

Durability: writes go to ``<dir>/tmp-<step>`` and are atomically renamed
to ``<dir>/step-<step>``, so a crash mid-write never corrupts the latest
checkpoint.  ``save`` copies every leaf to the host before it returns, so
the caller may update its tensors in place at once; the files are written
on a background thread (async checkpointing), which ``wait()`` joins.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

_SEP = "§"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``[(path entry, child)]`` of a node in ``jax.tree_util``'s order
    (dict keys sorted), or None for a leaf."""
    if _is_namedtuple(tree):
        return [(f"a:{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"k:{k}", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"i:{i}", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix=()) -> dict[str, Any]:
    """``{path key: leaf}``; None is an empty subtree, as in JAX."""
    if tree is None:
        return {}
    children = _children(tree)
    if children is None:
        return {_SEP.join(prefix): tree}
    flat = {}
    for entry, child in children:
        flat.update(_flatten(child, prefix + (entry,)))
    return flat


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of ``leaf`` on the host as numpy, bfloat16 widened to
    float32."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _rebuild(like, prefix, arrays):
    if like is None:
        return None
    children = _children(like)
    if children is None:
        arr = torch.from_numpy(arrays[_SEP.join(prefix)])
        return arr.to(device=like.device, dtype=like.dtype)
    rebuilt = [_rebuild(c, prefix + (e,), arrays) for e, c in children]
    if _is_namedtuple(like):
        return type(like)(*rebuilt)
    if isinstance(like, dict):
        keys = [e[2:] for e, _ in children]
        out = dict(zip(keys, rebuilt))
        return {k: out[k] for k in like}
    return type(like)(rebuilt)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot to host, then write asynchronously (or at once with
        ``blocking``)."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        manifest = {
            "step": int(step),
            "keys": sorted(host),
            "treedef": type(tree).__name__,
            "extra": extra or {},
        }

        def write():
            tmp = os.path.join(self.directory, f"tmp-{step}")
            final = os.path.join(self.directory, f"step-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, k in enumerate(manifest["keys"]):
                np.save(os.path.join(tmp, f"{i}.npy"), host[k])
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step-"):
                out.append(int(name.split("-", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        """Restore into the structure of ``like``: each leaf a new tensor of
        the template leaf's dtype on its device.  Returns (tree, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step-{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {
            k: np.load(os.path.join(d, f"{i}.npy"))
            for i, k in enumerate(manifest["keys"])
        }
        missing = set(_flatten(like)) - set(arrays)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        return _rebuild(like, (), arrays), manifest.get("extra", {})
