"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-parameter
xLSTM for a few hundred steps on synthetic data, with checkpoint/restart
and the straggler watchdog.  The twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--small] \
        [--mesh 1x1|DxM|PxDxM] [--device cpu]

``--small`` switches to the reduced config (seconds); the default trains
the full xlstm-125m config (0.13B parameters).  Both run the production
path, ``repro_torch.launch.train``: launcher -> (sharded) programs ->
supervisor loop, on the card unless ``--device`` names another device
(with no card it fails).
"""

import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    argv = [
        "--arch", "xlstm-125m",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--mesh", args.mesh,
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "100",
        "--log-every", "10",
    ]
    if args.small:
        argv += ["--reduced"]
    if args.device:
        argv += ["--device", args.device]
    train_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
