"""Wall ms a call of the Householder reduce (``linalg/householder.py``),
from the stage split."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "reduce", "householder")
