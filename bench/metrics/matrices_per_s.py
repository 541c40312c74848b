"""Matrices completed in the window over the window's time, up to the end
of the last completed call (host clock, closed loop)."""


def read(record: dict):
    lat = record["latencies_s"]
    if not lat:
        return None
    return len(lat) * record["matrices_per_call"] / record["window_s"]
