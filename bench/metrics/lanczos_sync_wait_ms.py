"""Host ms a traced call spends waiting for the card inside the Lanczos
reduce: the program's ``lanczos/sync`` spans."""

from bench import program_trace


def read(record: dict):
    return program_trace.span_ms(record, "lanczos/sync")
