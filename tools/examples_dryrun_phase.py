"""Run ``chip_smoke.py``'s phase 18 alone on one card.

    python3 tools/examples_dryrun_phase.py

Builds (or loads) the kernel library, then runs the example twins
(``examples/torch_*.py``) on the card with every launch count at 0 before
each, holding each launch against its plain version, and counts one period
of gemma2-2b at full width (a train and a decode cell) on ``"meta"`` and
again on the card: FLOPs and bytes must be equal and the argument bytes
within 1% of what the card allocates to place them.  It prints the
measured peak memory and step time beside the dry run's temp and
``bound_time``, and exits non-zero if a check fails.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("examples_dryrun_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    build.library()
    launches = smoke._phase_examples_dryrun(torch, torch.device("cuda"))
    print(f"[examples] launches: {launches}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
