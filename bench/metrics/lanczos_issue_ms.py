"""Host ms a traced call spends issuing the Lanczos steps: the self time
of the program's ``lanczos/step`` spans, each step's time outside its
``lanczos/sync`` waits."""

from bench import program_trace


def read(record: dict):
    return program_trace.span_ms(record, "lanczos/step", "self_s")
