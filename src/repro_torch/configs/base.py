"""Config schema: ModelConfig (architecture) and ShapeConfig (workload).

The port's own copy of ``repro.configs.base``, field for field.
"""

from __future__ import annotations

import dataclasses

# Block kinds (a block = mixer + FFN unless self-contained):
#   attn        global causal GQA + dense MLP
#   attn_local  sliding-window GQA + dense MLP
#   attn_moe    global causal GQA + MoE
#   mla         multi-head latent attention + dense MLP
#   mla_moe     MLA + MoE
#   cross       cross-attention (kv from ctx) + dense MLP
#   dec_cross   self-attn + cross-attn + dense MLP (enc-dec decoder layer)
#   attn_bidir  bidirectional attention + dense MLP (encoder layer)
#   mamba       Mamba2 block (self-contained)
#   mlstm       xLSTM matrix-memory block (self-contained)
#   slstm       xLSTM scalar-memory block (self-contained)
#   attn_shared shared-parameter attention block (Zamba2) — listed in
#               ``shared_blocks`` so its params are not stacked

Pattern = tuple[tuple[int, tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Pattern
    shared_blocks: tuple[str, ...] = ()
    head_dim: int | None = None
    # attention extras
    rope_theta: float = 10000.0
    window: int | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    # mla (deepseek)
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # ssm / recurrent
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # enc-dec (audio) / vlm stubs
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame embeddings (assignment: frontend stub)
    img_seq: int = 0  # precomputed patch embeddings (assignment: frontend stub)
    # misc
    activation: str = "swiglu"
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "all"  # all | dots (save matmul outputs) | none
    unroll_groups: bool = False  # unroll layer scans (roofline lowerings)
    attn_chunk: int = 1024
    sub_quadratic: bool = False  # may run long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not). Skips are recorded in EXPERIMENTS.md."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "full-attention arch: 512k dense KV decode out of scope"
    return True, ""
