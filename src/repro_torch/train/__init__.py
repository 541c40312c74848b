"""Step functions of ``repro.train``: the training step (``TrainState``,
``make_train_step``, microbatching) and the serving step."""

from repro_torch.train.steps import (  # noqa: F401
    TrainState,
    cast_tree,
    make_serve_step,
    make_train_step,
    put_batch,
)
