"""Step functions of ``repro.train``; this slice ports the serving step
(``make_serve_step``) and ``cast_tree``."""

from repro_torch.train.steps import cast_tree, make_serve_step  # noqa: F401
