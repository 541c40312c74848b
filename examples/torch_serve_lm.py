"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode with
sharded KV caches.  The twin of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch gemma2-2b] \
        [--mesh 1x1|DxM|PxDxM] [--device cpu]

Runs the reduced config through ``repro_torch.launch.serve``, on the card
unless ``--device`` names another device (with no card it fails); drop
``--reduced`` there and pass ``--mesh`` for a real mesh.
"""

import argparse
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    argv = [
        "--arch", args.arch, "--reduced",
        "--batch", str(args.batch),
        "--prompt-len", "32",
        "--gen", str(args.gen),
        "--mesh", args.mesh,
    ]
    if args.device:
        argv += ["--device", args.device]
    serve_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
