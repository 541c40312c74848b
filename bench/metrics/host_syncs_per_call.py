"""Times a call's host waits for the card: the program's ``host_sync``
count (a value read back, a copy from the host, an index by a mask) over
every call of the run."""

from bench import program_trace


def read(record: dict):
    return program_trace.count_per_call(record, "host_sync")
