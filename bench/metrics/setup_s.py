"""Set-up seconds: from the start of the process to the first timed call
(imports, the kernel build or its cache, the input pool and the warm-up)."""


def read(record: dict):
    return record["setup_s"]
