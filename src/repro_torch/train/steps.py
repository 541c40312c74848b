"""The serving step of ``repro.train.steps`` and ``cast_tree``.

``repro`` casts the parameters inside its jitted ``serve_step``, where XLA
folds the cast away.  Eager PyTorch would copy every weight on every
token, so callers cast once with :func:`cast_tree` before the decode loop:
``cast_tree`` of a tensor already in ``dtype`` returns it as it is, and the
step's own cast is then free.  The values are the same.  The training step
(``make_train_step``, ``TrainState``) comes with the trainer.
"""

from __future__ import annotations

import torch

from repro_torch.models.lm import LanguageModel


def cast_tree(tree, dtype):
    """Every floating tensor of a nested dict / list / tuple in ``dtype``
    (a tensor already in it is returned as it is); other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def make_serve_step(model: LanguageModel, compute_dtype=torch.bfloat16):
    """``serve_step(params, caches, token, pos) -> (next_token, caches)``:
    one greedy decode step in ``compute_dtype`` (caches updated in place)."""

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(
            cast_tree(params, compute_dtype), caches, token, pos)
        return torch.argmax(logits, dim=-1), caches

    return serve_step
