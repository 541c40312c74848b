"""Run ``chip_smoke.py``'s sharded-LM phase (17) alone on one card.

    python3 tools/mesh_lm_phase.py

Builds (or loads) the kernel library, then serves gemma2-2b at full width
on logical 1x2, 2x1 and 1x3 meshes of the card against its 1x1 path, one
period of deepseek-v3-671b on 1x2 in bfloat16 (logits and dropped tokens
against 1x1), trains gemma2-2b with EigenPre on 1x2 and on 2x1 under FSDP
against the 1x1 losses (computed here: phase 15's run), holding every
launch of the refresh's kernels against its plain version, and runs both
launchers with ``--mesh``.  It prints every time beside its 1x1 twin, the
peak memory and the bytes each mesh position holds, and exits non-zero if
a check fails.
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
        print("mesh_lm_phase: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    build.library()
    launches = smoke._phase_mesh_lm(torch, torch.device("cuda"))
    print(f"[mesh] launches: {launches}")
    print("nvidia-smi: " + smoke._gpu_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
