"""Full re-solves of a session per 1000 calls of the run: the program's
``session_resolve`` counter (any cause but a session's opening) over every
call, set-up's warm calls counted; each call is one update.  None where
the program never counted a fast update: a program without the session's
counters, or a run that made no fast update."""

from bench import program_trace


def read(record: dict):
    tracing = program_trace._tracing(record)
    if tracing is None:
        return None
    counts = tracing.counts()
    if "session_fast_update" not in counts:
        return None
    calls = (int(record["traffic"]["pool"]) + record["calls"]
             + record["split_calls"])
    return 1e3 * counts.get("session_resolve", 0) / calls
