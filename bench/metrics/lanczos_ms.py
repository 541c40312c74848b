"""Wall ms a call of the Lanczos reduce (``linalg/lanczos.py``), from the
stage split."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "reduce", "krylov")
