"""Run ``chip_smoke.py``'s LM phase (14) alone on one card.

    python3 tools/lm_phase.py

Serves gemma2-2b (float32, then bfloat16) and whisper-large-v3 at their
full published widths with seeded weights through ``LanguageModel``'s
prefill and decode, checks every logit, the float64 and the
prefill / decode consistency gates, prints the times beside their bounds
and the peak memory, then runs ``launch/serve.py --arch gemma2-2b`` in a
subprocess.  The path builds no kernel.  It exits non-zero if a check
fails.
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
        print("lm_phase: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    smoke._phase_lm(torch, torch.device("cuda"))
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
