"""Frozen peaks of one NVIDIA H100 SXM and the per-step operation counts.

These numbers are the yardstick: they never follow the program.  Peaks are
NVIDIA's data sheet for the SXM part at its 700 W limit; a card set below
that limit reads lower against them, so every reading is kept beside the
card's power limit.
"""

#: FP64 outside the tensor cores: the rate the Sturm and prod-diff kernels
#: can reach (neither can use tensor cores).  FP32 outside them, likewise.
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
#: The denominator of ``eei_mfu``: the FP64 tensor-core peak for float64;
#: float32 work runs outside the tensor cores (TF32 is off), at 67e12.
PEAK_MFU = {"float64": 67e12, "float32": 67e12}
#: HBM3 bandwidth.
PEAK_BYTES = 3.35e12

#: Operations of one Sturm recurrence step: a divide, two subtracts, an
#: abs, two compares, a select and an integer add.
STURM_OPS_PER_STEP = 8
#: Operations of one prod-diff term: a subtract, an abs, a max, a log, an
#: add.
PROD_DIFF_OPS_PER_TERM = 5
#: Bisection levels counted per eigenvalue: the program's default
#: iteration count per dtype, frozen here as numbers (the most a lane
#: takes; the kernel's tree stops a bracket early once it is converged).
LEVELS = {"float64": 64, "float32": 32}

ELEMENT_BYTES = {"float64": 8, "float32": 4}


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    over the non-tensor peak and the bytes over the bandwidth."""
    return max(ops / PEAK_OPS[precision], nbytes / PEAK_BYTES)
