"""The whole call's share of the card's peak: FLOPs counted from shapes
(``bench/flops.py``) for the profiled calls, over the profiled window times
the frozen peak (FP64 tensor cores for float64), in %."""

from bench import roofline


def read(record: dict):
    if record["device_type"] != "cuda":
        return None
    peak = roofline.PEAK_MFU[record["precision"]]
    return 100.0 * record["flops"] / (record["window_s"] * peak)
