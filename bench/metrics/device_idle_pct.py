"""Share of the profiled window in which no kernel, copy or memset ran on
the card, in %."""


def read(record: dict):
    if record["device_type"] != "cuda" or record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
