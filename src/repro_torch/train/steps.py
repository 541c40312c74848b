"""Training and serving step factories, the twins of ``repro.train.steps``.

    train_step(state, batch)               -> (state, metrics)
    serve_step(params, caches, token, pos) -> (next_token, caches)

The trainer holds ``repro``'s layout: :class:`TrainState`'s parameters are
``repro``'s flat dict with each layer group stacked on a leading axis
(``LanguageModel.stacked_dict``), so the optimizer sees ``repro``'s tree
key for key: ``EigenPre``'s eligibility, the global norm and the
checkpoint's keys all match.  Each step casts the stacked tensors to the
compute dtype and unbinds them once into the per-layer dict the model's
loss takes (``LanguageModel.unstack``).  Master parameters stay float32;
gradients and the update are float32 (``AdamW``).  ``repro``'s launcher
donates the state to its jitted step; the port's step updates it in place.
``step`` is a 0-d int32 CPU tensor, so the schedule and ``EigenPre``'s
refresh decision cost no device sync.

``repro`` casts the parameters inside its jitted ``serve_step``, where XLA
folds the cast away.  Eager PyTorch would copy every weight on every
token, so callers cast once with :func:`cast_tree` before the decode loop:
``cast_tree`` of a tensor already in ``dtype`` returns it as it is, and the
step's own cast is then free.  The values are the same.  Not ported:
``repro``'s sharded programs (``build_programs`` and the spec trees), which
wait with the sharded LM.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.lm import LanguageModel
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.microbatch import accumulated_grads


class TrainState(NamedTuple):
    params: dict  # repro's flat dict, layer groups stacked on axis 0
    opt_state: Any  # AdamWState or EigenPreState
    step: torch.Tensor  # 0-d int32, on the CPU


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


def put_batch(batch: dict, device) -> dict:
    """A numpy batch (``data.SyntheticLM``'s) as tensors on ``device``;
    integer arrays become int64, the index dtype of the embedding and the
    loss's gather."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(
    model: LanguageModel,
    optimizer=None,
    compute_dtype=torch.bfloat16,
    schedule: Callable = warmup_cosine,
    microbatch: int | None = None,
):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    float32 gradients in ``compute_dtype`` (accumulated over
    ``microbatch`` microbatches when > 1), then ``optimizer.update`` (AdamW
    by default) at ``schedule(state.step)``.  The state is updated in
    place and returned with ``step + 1``; ``metrics`` holds the model's
    (``ce``, ``aux``), ``loss``, ``lr_scale`` and the optimizer's
    (``grad_norm``)."""
    optimizer = optimizer or AdamW()
    n_micro = microbatch if microbatch and microbatch > 1 else 1

    def loss_fn(params, batch):
        return model.loss(model.unstack(cast_tree(params, compute_dtype)),
                          batch)

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = accumulated_grads(loss_fn, state.params,
                                                 batch, n_micro)
        lr_scale = schedule(state.step)
        new_params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, lr_scale)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale, **opt_metrics)
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return train_step
