"""Wall ms a call of the minor-spectra stage (kernel 1 on the b * n minor
bands), from the stage split."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "minor_spectra")
