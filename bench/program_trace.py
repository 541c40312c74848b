"""The program's own spans and counters (``repro_torch.tracing``) at the
end of a traced run, for the readers in ``bench/metrics/``.

The program keeps a span only while a profiler records, so the spans cover
the traced calls alone.  Its counters are always on, so they cover every
call of the run: one warm-up call a stack of the pool, the traced calls and
the stage-split calls.  The harness also runs over checkouts of older
commits, whose program has no such module: there the readers return None,
as they do on the CPU, where the host waits for no device.
"""


def _tracing(record: dict):
    if record["device_type"] != "cuda":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def count_per_call(record: dict, name: str):
    """The counter ``name`` a call of the run (0 where the program never
    counted it)."""
    tracing = _tracing(record)
    if tracing is None:
        return None
    total = tracing.counts().get(name, 0)
    calls = (int(record["traffic"]["pool"]) + record["calls"]
             + record["split_calls"])
    return total / calls


def span_ms(record: dict, name: str, key: str = "s"):
    """Host ms a traced call of the spans named ``name`` or nested under it
    by name (``name/...``): their time (``key="s"``) or their self time
    (``"self_s"``); None where no such span was closed."""
    tracing = _tracing(record)
    if tracing is None:
        return None
    found = [entry[key] for span, entry in tracing.spans().items()
             if span == name or span.startswith(name + "/")]
    if not found:
        return None
    return 1e3 * sum(found) / record["calls"]
