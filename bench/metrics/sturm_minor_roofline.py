"""Kernel 1 in the minor-spectra stage: its least time on the card (frozen
peaks; the b * n bands of n - 1, every eigenvalue bisected LEVELS times)
over its profiled device time, in %."""

from bench import flops, roofline, trace


def read(record: dict):
    if record["device_type"] != "cuda":
        return None
    t = trace.kernel_s(record, "minor_spectra", "sturm")
    if t is None:
        return None
    n, b = int(record["config"]["n"]), int(record["traffic"]["b"])
    prec = record["precision"]
    rows, band = b * n, n - 1
    ops = flops.sturm_ops(rows, band, band, roofline.LEVELS[prec])
    nbytes = flops.sturm_bytes(rows, band, band, roofline.ELEMENT_BYTES[prec])
    return 100.0 * roofline.bound_s(ops, nbytes, prec) / t
