"""Wall ms a call of the recover stage (``core/directions.py``'s sign
recurrence and the back-transform), from the stage split."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "recover")
