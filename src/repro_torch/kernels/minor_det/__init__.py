"""The minor-determinant magnitudes kernel: ``kernel`` (the CUDA wrapper and
its plain version) and ``ops`` (the public entry point)."""
