"""Run ``chip_smoke.py``'s trainer phase (15) alone on one card.

    python3 tools/train_phase.py

Builds (or loads) the kernel library, then trains gemma2-2b at its full
published width with EigenPre (train_4k's 4096 tokens, a global batch of
2 in 2 microbatches, remat, float32, 3 steps and one bfloat16 step), its
refresh launching kernels 1 and 2, each launch held against its plain
version; the float64, remat and microbatch gates at depth 2; reduced
codeqwen1.5-7b's 30 EigenPre steps; and ``launch/train.py`` in
subprocesses (checkpoints, ``--resume``, SIGTERM).  It prints the step
time beside its bound, tokens/s, the refresh's time and the peak memory,
and exits non-zero if a check fails.
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
        print("train_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    build.library()
    launches, record = smoke._phase_train(torch, torch.device("cuda"))
    print(f"[train] record: {record}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
