"""95th percentile of every call's latency in the window, in ms (host
clock, from the call to the synchronise after it)."""

import statistics


def read(record: dict):
    lat = record["latencies_s"]
    if len(lat) < 2:
        return None
    ms = [x * 1e3 for x in lat]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
