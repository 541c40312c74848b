"""Host ms of one full re-solve of a session: the program's
``session/resolve`` spans (``engine/session.py``: the top-k solve of the
retained window, its host verify and host reseed, the Frobenius norm),
their total time over their count in the traced calls."""

from bench import program_trace


def read(record: dict):
    tracing = program_trace._tracing(record)
    if tracing is None:
        return None
    entry = tracing.spans().get("session/resolve")
    if not entry or not entry["n"]:
        return None
    return 1e3 * entry["s"] / entry["n"]
