"""Gradient accumulation over microbatches, the twin of
``repro.train.microbatch``.

The global batch splits into ``n`` microbatches along its leading axis;
each runs forward and backward in turn, and the float32 gradients
accumulate in place (autograd's ``.grad`` of float32 leaves), so only one
microbatch's activations and one set of gradients are alive at a time.
"""

from __future__ import annotations

import torch


def accumulated_grads(loss_fn, params: dict, batch: dict, n_micro: int):
    """``loss_fn(params, microbatch) -> (loss, metrics)``, differentiable in
    ``params`` (a flat dict of tensors).

    Returns ``(mean loss, the last microbatch's metrics, grads)``: the
    gradients of the float32 view of ``params``, summed in float32 over
    the microbatches and divided by ``n_micro``, as ``repro`` does."""
    sizes = {x.shape[0] for x in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n_micro:
        raise ValueError(f"batch rows {sorted(sizes)} do not split into "
                         f"{n_micro} microbatches")
    mb = next(iter(sizes)) // n_micro
    leaves = {k: p.detach().float().requires_grad_()
              for k, p in params.items()}
    loss_sum, metrics = None, {}
    for i in range(n_micro):
        micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
        loss, metrics = loss_fn(leaves, micro)
        loss.backward()
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        metrics = {k: v.detach() for k, v in metrics.items()}
    grads = {}
    for k, leaf in leaves.items():
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        grads[k] = g.div_(n_micro) if n_micro > 1 else g
    return loss_sum / n_micro, metrics, grads
