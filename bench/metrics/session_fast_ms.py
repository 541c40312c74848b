"""Host ms a traced call spends in a session update's fast path: the
program's ``session/fast`` spans (``engine/session.py``: from the update
norm's read to the state commit, the update program's stages and its
verify flag's read inside)."""

from bench import program_trace


def read(record: dict):
    return program_trace.span_ms(record, "session/fast")
