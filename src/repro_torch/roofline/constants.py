"""NVIDIA H100 SXM5 constants for the roofline model (per card).

The twin of ``repro.roofline.constants``, whose numbers are a TPU's; these
are the H100 SXM5's, from NVIDIA's H100 Tensor Core GPU data sheet (dense
rates, no sparsity, at the card's full 700 W power limit):

* ``PEAK_FLOPS_BF16``: 989 TFLOP/s of dense bfloat16 on the tensor cores.
* ``HBM_BW``: 3.35 TB/s of HBM3.
* ``HBM_PER_CHIP``: 80 GB of HBM3.
* ``LINK_BW``: one link per card, as ``repro``'s roofline counts one
  inter-chip link a chip.  The production mesh's ``model`` axis of 16
  spans two 8-GPU nodes, so a collective over it crosses the nodes'
  InfiniBand: NDR at 400 Gb/s a GPU, 50e9 B/s, binds, not NVLink 4's
  450 GB/s a direction inside a node.
"""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
LINK_BW = 50e9  # B/s, one InfiniBand NDR link a card
HBM_PER_CHIP = 80e9  # bytes
