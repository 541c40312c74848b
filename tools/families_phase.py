"""Run ``chip_smoke.py``'s block-family phase (16) alone on one card.

    python3 tools/families_phase.py

Builds (or loads) the kernel library, then serves zamba2-2.7b and
xlstm-125m whole at their published widths (float32 and bfloat16, prompts
of 4096 tokens) and kimi-k2-1t-a32b and deepseek-v3-671b at one period of
their patterns with all experts (bfloat16, prompts of 2048), with the
float64 and prefill / decode gates; trains zamba2 and xlstm at full width
with EigenPre (their refresh launching kernels 1 and 2, each launch held
against its plain version) and reduced kimi and deepseek with AdamW.  It
prints every time beside its bound and the peak memory, and exits non-zero
if a check fails.
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
        print("families_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    build.library()
    launches = smoke._phase_families(torch, torch.device("cuda"))
    print(f"[families] launches: {launches}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
