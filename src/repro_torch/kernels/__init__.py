"""Hand-written CUDA kernels of the port, each beside its plain version.

``sturm`` holds the Sturm bisection kernels (full bands, and segmented
bands with per-lane brackets), ``prod_diff`` the log-sum kernels
(batched, masked, single matrix) and ``minor_det`` the windowed
minor-determinant magnitudes; their CUDA sources are under ``csrc/`` and
are built by ``build`` at first use.
Importing these modules needs neither ``nvcc`` nor a card.
"""
