"""The prod-diff log-sum kernel: ``kernel`` (CUDA wrapper and plain
version), ``ops`` (public entry points) and ``ref`` (pure-PyTorch oracle)."""
