"""Wall ms a call of the session update program's ``tridiag_bracketed``
stage (``engine/engine.py``'s ``_b_tridiag_bracketed``: the lanes'
brackets from rank-1 interlacing and the secular refinement, then the
bracketed bisection, kernel 3 on the card), from the stage split; None
where no split call ran the update program."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "spectrum", "tridiag_bracketed")
