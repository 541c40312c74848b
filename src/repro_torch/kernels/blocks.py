"""Block-size and bucket helpers, the port's copy of ``repro.kernels.blocks``.

``pow2_bucket`` rounds stack sizes to powers of two (the serving runtime's
shape buckets); ``clamp_block`` / ``clamp_batch_block`` clamp a requested
tile to the padded problem shape so a small problem never pads to a full
default tile.  ``pack_segments`` lays requests out as segments of packed
rows, the layout ``engine.packed_topk_program`` takes.
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


def pack_segments(lengths, row_width: int, max_slots: int,
                  align: int = 8) -> list:
    """First-fit pack of segment lengths into rows of ``row_width``.

    Each length is rounded up to ``align`` (its footprint: segments start
    on aligned columns) and placed in the first row with room for it and a
    free slot.  Returns the rows, each a list of ``(index, offset,
    length)`` triples: ``index`` in ``lengths``, ``offset`` the aligned
    start column and ``length`` the unpadded length (the slack up to the
    next offset is guard columns).
    """
    if row_width < align:
        raise ValueError(f"row_width {row_width} < align {align}")
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    rows = []  # [used columns, slots]
    for idx, length in enumerate(lengths):
        if length < 1:
            raise ValueError(f"segment length must be >= 1, got {length}")
        footprint = -(-length // align) * align
        if footprint > row_width:
            raise ValueError(
                f"segment length {length} (footprint {footprint}) exceeds "
                f"row width {row_width}")
        for row in rows:
            if row[0] + footprint <= row_width and len(row[1]) < max_slots:
                row[1].append((idx, row[0], length))
                row[0] += footprint
                break
        else:
            rows.append([footprint, [(idx, 0, length)]])
    return [slots for _, slots in rows]
