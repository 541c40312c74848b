"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke configs).

The port's own copy of ``repro.configs.registry``, entry for entry and field
for field (``tests/test_torch_lm.py`` holds the two equal).  Deviations from
the published sources are listed in each config's ``notes``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# [ssm] xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517]
# ---------------------------------------------------------------------------
XLSTM_125M = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    pattern=((6, ("mlstm", "slstm")),),  # xLSTM[1:1] alternation
    ssm_chunk=128, sub_quadratic=True, tie_embeddings=True,
    notes="d_ff=0: blocks carry internal projections (mLSTM expand=2, "
          "sLSTM post-FFN 4/3). Gate softcap replaces running-max stabilizer.",
)

# ---------------------------------------------------------------------------
# [dense] CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]
# ---------------------------------------------------------------------------
CODEQWEN_7B = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92416, rope_theta=1_000_000.0,
    pattern=((32, ("attn",)),),
)

# ---------------------------------------------------------------------------
# [dense] StarCoder2-7B — GQA, RoPE [arXiv:2402.19173]
# ---------------------------------------------------------------------------
STARCODER2_7B = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab_size=49152, activation="gelu", rope_theta=1_000_000.0,
    pattern=((32, ("attn",)),),
    notes="GeLU MLP per paper; RMSNorm used where the release uses LayerNorm.",
)

# ---------------------------------------------------------------------------
# [dense] Gemma2-2B — local/global alternation, softcaps [arXiv:2408.00118]
# ---------------------------------------------------------------------------
GEMMA2_2B = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab_size=256000, head_dim=256, window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    embed_scale=True, tie_embeddings=True, activation="gelu",
    pattern=((13, ("attn_local", "attn")),),
)

# ---------------------------------------------------------------------------
# [dense] Granite-20B — MQA llama-arch code model [arXiv:2405.04324]
# ---------------------------------------------------------------------------
GRANITE_20B = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, activation="gelu",
    pattern=((52, ("attn",)),),
    notes="MQA (kv=1): KV-cache sharding falls back to the sequence axis "
          "(repro.sharding.rules). GeLU 2-matrix MLP (gpt-bigcode lineage) "
          "matches the published 20B count.",
)

# ---------------------------------------------------------------------------
# [moe] Kimi-K2 1T-A32B — 384 experts top-8 [arXiv:2501.kimi2, paper table]
# ---------------------------------------------------------------------------
KIMI_K2 = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=18432,
    vocab_size=163840, head_dim=128,
    n_experts=384, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    pattern=((1, ("attn",)), (60, ("attn_moe",))),
    rope_theta=50_000.0,
    notes="Assignment d_ff=2048 is the per-expert hidden (moe_d_ff); the "
          "single dense layer uses 18432. GQA per assignment (release is MLA).",
)

# ---------------------------------------------------------------------------
# [moe] DeepSeek-V3 671B — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437]
# ---------------------------------------------------------------------------
DEEPSEEK_V3 = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    pattern=((3, ("mla",)), (58, ("mla_moe",))),
    notes="First 3 layers dense-FFN (paper); assignment d_ff=2048 is the "
          "per-expert hidden. Softmax top-k router stands in for the "
          "sigmoid+bias-corrected router; MTP head not modeled.",
)

# ---------------------------------------------------------------------------
# [audio] Whisper-large-v3 — enc-dec, conv frontend stubbed [arXiv:2212.04356]
# ---------------------------------------------------------------------------
WHISPER_LARGE_V3 = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, activation="gelu",
    n_enc_layers=32, enc_seq=1500,
    pattern=((32, ("dec_cross",)),),
    notes="Frontend stub per assignment: input_specs() feeds precomputed "
          "frame embeddings (B, 1500, d). RoPE stands in for learned "
          "decoder positions.",
)

# ---------------------------------------------------------------------------
# [vlm] Llama-3.2-Vision-90B — cross-attn image layers [hf:meta-llama]
# ---------------------------------------------------------------------------
LLAMA32_VISION_90B = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, rope_theta=500_000.0,
    img_seq=1600,
    pattern=((20, ("attn", "attn", "attn", "attn", "cross")),),
    notes="Vision frontend stub per assignment: precomputed patch embeddings "
          "(B, 1600, d). Cross-attn every 5th layer, tanh-gated.",
)

# ---------------------------------------------------------------------------
# [hybrid] Zamba2-2.7B — Mamba2 + shared attention [arXiv:2411.15242]
# ---------------------------------------------------------------------------
ZAMBA2_2P7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    pattern=((9, ("mamba", "mamba", "mamba", "mamba", "mamba", "attn_shared")),),
    shared_blocks=("attn_shared",),
    sub_quadratic=True,
    notes="One shared-parameter attention block applied every 6th position "
          "(the release concatenates original embeddings into the shared "
          "block; we apply it on the residual stream).",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        XLSTM_125M, CODEQWEN_7B, STARCODER2_7B, GEMMA2_2B, GRANITE_20B,
        KIMI_K2, DEEPSEEK_V3, WHISPER_LARGE_V3, LLAMA32_VISION_90B,
        ZAMBA2_2P7B,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests (one step, no NaNs)."""
    kv = 2 if cfg.n_kv_heads < cfg.n_heads else 4
    pattern = tuple((min(r, 2), kinds) for r, kinds in cfg.pattern)
    n_layers = sum(r * len(k) for r, k in pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        pattern=pattern,
        window=16 if cfg.window else None,
        n_experts=8 if cfg.n_experts else 0,
        top_k=2 if cfg.top_k else 0,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=16 if cfg.enc_seq else 0,
        img_seq=16 if cfg.img_seq else 0,
        attn_chunk=16,
        remat=False,
    )
