"""Block-size and bucket helpers, the port's copy of ``repro.kernels.blocks``.

``pow2_bucket`` rounds stack sizes to powers of two (the serving runtime's
shape buckets); ``clamp_block`` / ``clamp_batch_block`` clamp a requested
tile to the padded problem shape so a small problem never pads to a full
default tile.  ``pack_segments`` waits for the packed serving path.
"""

from __future__ import annotations


def pow2_bucket(x: int) -> int:
    """Smallest power of two ``>= x`` (``x >= 1``)."""
    if x < 1:
        raise ValueError(f"bucket size must be >= 1, got {x}")
    return 1 << (x - 1).bit_length()


def clamp_batch_block(requested: int, b: int) -> int:
    """Batch-axis block near ``requested`` for a ``b``-row stack.

    Snaps to a power of two so a pow2-bucketed stack always runs full
    steps, and never exceeds ``pow2_bucket(b)``.
    """
    clamped = clamp_block(requested, b, align=1)
    return min(pow2_bucket(clamped), pow2_bucket(b))


def clamp_block(requested: int, dim: int, align: int = 8) -> int:
    """Aligned block near ``requested`` that does not overshoot ``dim``.

    Returns ``min(requested, round_up(dim, align))`` rounded up to a
    multiple of ``align``: a small problem pads by at most ``align - 1``
    entries.  ``align=1`` disables alignment.
    """
    if requested < 1:
        raise ValueError(f"block size must be >= 1, got {requested}")
    dim = max(dim, 1)
    rounded = -(-dim // align) * align
    clamped = min(requested, rounded)
    return max(align, -(-clamped // align) * align)
