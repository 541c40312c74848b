"""Kernel 2 (``kernels/prod_diff``) in the components stage: its least time
on the card (frozen peaks; the b x n x n x (n - 1) log-difference table)
over its profiled device time, in %."""

from bench import flops, roofline, trace


def read(record: dict):
    if record["device_type"] != "cuda":
        return None
    t = trace.kernel_s(record, "components", "logabs_sum")
    if t is None:
        return None
    n, b = int(record["config"]["n"]), int(record["traffic"]["b"])
    prec = record["precision"]
    ops = flops.prod_diff_ops(b, n, n, n - 1)
    nbytes = flops.prod_diff_bytes(b, n, n, n - 1,
                                   roofline.ELEMENT_BYTES[prec])
    return 100.0 * roofline.bound_s(ops, nbytes, prec) / t
