"""Wall ms a call of the session update program's ``warm_project`` stage
(``engine/engine.py``'s ``_b_warm_project``: the QR of the kept rows, the
frame of the update and its Krylov directions, ``S A' S^T`` and its
Householder to a band), from the stage split; None where no split call
ran the update program."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "reduce", "warm_project")
