"""The prod-diff log-sum kernels: ``kernel`` (CUDA wrappers and plain
versions), ``ops`` (public entry points) and ``ref`` (pure-PyTorch oracle)."""
