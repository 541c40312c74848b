"""Hand-written CUDA kernels of the port, each beside its plain version.

``sturm`` and ``prod_diff`` hold the main path's two kernels; their CUDA
sources are under ``csrc/`` and are built by ``build`` at first use.
Importing these modules needs neither ``nvcc`` nor a card.
"""
