"""Run ``chip_smoke.py``'s minor-determinant phase (19) alone on one card.

    python3 tools/minor_det_phase.py

Builds (or loads) the kernel library, prints the minor-determinant
kernel's ``nvcc -Xptxas -v`` figures, holds the kernel against its plain
version at the main path's shapes and times both, then runs the Krylov
top-k at the benchmark's topk8 and topk16 shapes through it.  Prints the
records as one JSON line and the card's name and power limit; exits
non-zero if a check fails.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("minor_det_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.library()
    report = (build.library_dir() / "ptxas.txt").read_text()
    print("\n".join(line for line in report.split("== ")[1:]
                    if line.startswith("minor_det.cu")))
    records = smoke._phase_minor_det(torch, torch.device("cuda"))
    print(json.dumps({"kernels": records}))
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
