"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json``; everything that belongs
to one configuration, cell, operation or metric is a file of its own under
``configs/``, ``workloads/``, ``ops/`` and ``metrics/``, found by name.
Importing this package imports nothing.
"""
