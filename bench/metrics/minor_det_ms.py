"""Wall ms a call of the top-k chain's ``minor_det`` stage
(``core/identity.py``'s ``tridiag_minor_logdets``: the window's magnitudes
from the band's minor determinants), from the stage split."""

from bench import trace


def read(record: dict):
    return trace.stage_ms(record, "components", "minor_det")
