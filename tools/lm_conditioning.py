"""How well-conditioned the LM phase's random-weight models are, by depth.

    python3 tools/lm_conditioning.py

For whisper-large-v3 at full width with 1, 2, 4, 8, 16 and 32 encoder and
decoder layers, and gemma2-2b at full width and depth, with the weights
and prompts of ``chip_smoke.py``'s LM phase (seeded, 2 prompts; whisper's
of 224 tokens, gemma2's of 1024): the float32 prefill's last logits
against a float64 run of the same weights; the float64 run against
itself with its input nudged by 2**-24 (whisper's frames, gemma2's
embedding table); and a prefill of all but 8 prompt tokens plus 8 decode
steps against the whole prefill, in float32 and float64.  Each as a
fraction of max |logit|.  Where the nudge alone moves float64 by O(1), no
two orders of rounding can be held to each other.  Needs the card.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TAIL = 8


def _rel(a, b) -> float:
    b = b.double()
    return float((a.double() - b).abs().max() / b.abs().max())


def _consistency(model, params, batch, prompt):
    head = {k: v[:, :-TAIL] if k in ("tokens", "labels") else v
            for k, v in batch.items()}
    _, caches = model.prefill(params, head, prompt + 16)
    for pos in range(prompt - TAIL, prompt):
        step, caches = model.decode_step(params, caches,
                                         batch["tokens"][:, pos], pos)
    return step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_conditioning: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import LanguageModel
    from repro_torch.train.steps import cast_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    whisper, gemma = get_config("whisper-large-v3"), get_config("gemma2-2b")
    runs = [(dataclasses.replace(whisper, n_layers=d, n_enc_layers=d,
                                 pattern=((d, ("dec_cross",)),)), 224)
            for d in (1, 2, 4, 8, 16, 32)] + [(gemma, 1024)]
    with torch.inference_mode():
        for cfg, prompt in runs:
            model = LanguageModel(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(0))
            batch = lm_batch(cfg, 2, prompt, 0, dev)
            p32 = model.param_dict()
            p64 = cast_tree(p32, torch.float64)
            b64 = cast_tree(batch, torch.float64)
            l32 = model.prefill(p32, batch, prompt + 16)[0]
            l64 = model.prefill(p64, b64, prompt + 16)[0]
            nudge = 1 + 2.0 ** -24
            if "frames" in b64:
                moved = model.prefill(
                    p64, dict(b64, frames=b64["frames"] * nudge),
                    prompt + 16)[0]
            else:
                moved = model.prefill(
                    dict(p64, **{"embed/tokens": p64["embed/tokens"] * nudge}),
                    b64, prompt + 16)[0]
            c32 = _consistency(model, p32, batch, prompt)
            c64 = _consistency(model, p64, b64, prompt)
            print(f"{cfg.name} depth {cfg.n_enc_layers or ''}"
                  f"{' + ' if cfg.n_enc_layers else ''}{cfg.n_layers}: "
                  f"float32 vs float64 {_rel(l32, l64):.3e}; float64 nudged "
                  f"by 2**-24 {_rel(moved, l64):.3e}; prefill of "
                  f"{prompt - TAIL} + {TAIL} steps vs prefill of {prompt}: "
                  f"float32 {_rel(c32, l32):.3e}, float64 "
                  f"{_rel(c64, l64):.3e}", flush=True)
            del model, p32, p64
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
