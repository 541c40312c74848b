"""Block assembly: ModelConfig block-kind -> params, apply, decode, cache.

The twin of ``repro.models.blocks`` for the attention-family kinds
(``PORTED_KINDS``): a block is one residual unit, pre-norm mixer plus
pre-norm MLP.  Every other kind of ``repro`` (``attn_moe``, ``mla``,
``mla_moe``, ``mamba``, ``mlstm``, ``slstm``, ``attn_shared``) raises a
``NotImplementedError`` that names it; :func:`check_ported` refuses a
config that holds one before a model is built.  All functions are pure but
for decode's cache writes; parameters are flat ``{path: tensor}`` dicts
scoped by the caller.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.params import (
    ParamDecl,
    ParamTable,
    merge_tables,
    prefix_table,
)

#: The block kinds the port runs.
PORTED_KINDS = ("attn", "attn_local", "attn_bidir", "cross", "dec_cross")
#: Self-attention + MLP kinds among them.
_ATTN_KINDS = ("attn", "attn_local", "attn_bidir")


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported to repro_torch yet (ported: "
        f"{', '.join(PORTED_KINDS)})")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first block kind of ``cfg``
    that the port does not run."""
    kinds = [k for _, ks in cfg.pattern for k in ks] + list(cfg.shared_blocks)
    for kind in kinds:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(f"{cfg.name}: {_unported(kind)}")


# ---------------------------------------------------------------------------
# Sub-config builders
# ---------------------------------------------------------------------------


def attn_config(cfg: ModelConfig, kind: str) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta,
        causal=kind != "attn_bidir",
        window=cfg.window if kind == "attn_local" else None,
        softcap=cfg.attn_softcap,
        use_rope=kind != "attn_bidir" or cfg.family != "audio",
        chunk_q=cfg.attn_chunk,
        chunk_k=cfg.attn_chunk,
    )


def mlp_config(cfg: ModelConfig) -> mlp.MLPConfig:
    return mlp.MLPConfig(cfg.d_model, cfg.d_ff, cfg.activation)


def _norm(name: str, d: int) -> ParamTable:
    return {name: ParamDecl((d,), ("embed",), init="zeros")}


# ---------------------------------------------------------------------------
# Param tables per block kind
# ---------------------------------------------------------------------------


def block_param_table(cfg: ModelConfig, kind: str) -> ParamTable:
    d = cfg.d_model
    if kind in _ATTN_KINDS:
        return merge_tables(
            _norm("ln1", d),
            prefix_table("attn", attn.attn_param_table(attn_config(cfg, kind))),
            _norm("ln2", d),
            prefix_table("mlp", mlp.mlp_param_table(mlp_config(cfg))),
        )
    if kind == "cross":
        return merge_tables(
            _norm("ln1", d),
            prefix_table("xattn", attn.attn_param_table(attn_config(cfg, kind))),
            _norm("ln2", d),
            prefix_table("mlp", mlp.mlp_param_table(mlp_config(cfg))),
            {"xgate": ParamDecl((1,), (None,), init="zeros")},  # llama-vision gate
        )
    if kind == "dec_cross":
        return merge_tables(
            _norm("ln1", d),
            prefix_table("attn", attn.attn_param_table(attn_config(cfg, kind))),
            _norm("lnx", d),
            prefix_table("xattn", attn.attn_param_table(attn_config(cfg, kind))),
            _norm("ln2", d),
            prefix_table("mlp", mlp.mlp_param_table(mlp_config(cfg))),
        )
    raise _unported(kind)


def _sub(p: dict, prefix: str) -> dict:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                ctx: dict):
    """Returns (x, aux_loss, kv) — kv is the prefill cache payload.  The
    attention-family kinds have no auxiliary loss (``repro``'s is 0)."""
    eps = cfg.norm_eps
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _ATTN_KINDS:
        acfg = attn_config(cfg, kind)
        h, kv = attn.self_attention(acfg, _sub(p, "attn"),
                                    common.rms_norm(x, p["ln1"], eps),
                                    ctx["positions"])
        x = x + h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, zero, kv
    if kind == "cross":
        acfg = attn_config(cfg, kind)
        h, kv = attn.cross_attention(acfg, _sub(p, "xattn"),
                                     common.rms_norm(x, p["ln1"], eps),
                                     ctx["kv_src"])
        x = x + torch.tanh(p["xgate"]).to(x.dtype) * h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, zero, kv
    if kind == "dec_cross":
        acfg = attn_config(cfg, kind)
        h, kv_self = attn.self_attention(acfg, _sub(p, "attn"),
                                         common.rms_norm(x, p["ln1"], eps),
                                         ctx["positions"])
        x = x + h
        h, kv_cross = attn.cross_attention(acfg, _sub(p, "xattn"),
                                           common.rms_norm(x, p["lnx"], eps),
                                           ctx["kv_src"])
        x = x + h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, zero, (kv_self, kv_cross)
    raise _unported(kind)


# ---------------------------------------------------------------------------
# Decode (one token, cache update)
# ---------------------------------------------------------------------------


def decode_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                 cache, ctx: dict):
    """One token through the block; self-attention caches are written in
    place at ``ctx["pos"]``, cross-attention caches only read."""
    eps = cfg.norm_eps
    pos = ctx["pos"]
    if kind in _ATTN_KINDS:
        acfg = attn_config(cfg, kind)
        h, cache_new = attn.self_attention_decode(
            acfg, _sub(p, "attn"), common.rms_norm(x, p["ln1"], eps), cache, pos)
        x = x + h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, cache_new
    if kind == "cross":
        acfg = attn_config(cfg, kind)
        h, cache_new = attn.cross_attention_cached(
            acfg, _sub(p, "xattn"), common.rms_norm(x, p["ln1"], eps), cache)
        x = x + torch.tanh(p["xgate"]).to(x.dtype) * h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, cache_new
    if kind == "dec_cross":
        acfg = attn_config(cfg, kind)
        h, self_new = attn.self_attention_decode(
            acfg, _sub(p, "attn"), common.rms_norm(x, p["ln1"], eps),
            cache["self"], pos)
        x = x + h
        h, cross_new = attn.cross_attention_cached(
            acfg, _sub(p, "xattn"), common.rms_norm(x, p["lnx"], eps),
            cache["cross"])
        x = x + h
        h = mlp.mlp(mlp_config(cfg), _sub(p, "mlp"),
                    common.rms_norm(x, p["ln2"], eps))
        return x + h, {"self": self_new, "cross": cross_new}
    raise _unported(kind)


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, smax: int, dtype):
    if kind in _ATTN_KINDS:
        return attn.attn_cache_spec(attn_config(cfg, kind), batch, smax, dtype)
    if kind == "cross":
        acfg = attn_config(cfg, kind)
        shp = (batch, cfg.img_seq, acfg.n_kv_heads, acfg.head_dim)
        return {"k": attn.TensorSpec(shp, dtype),
                "v": attn.TensorSpec(shp, dtype)}
    if kind == "dec_cross":
        acfg = attn_config(cfg, kind)
        xshp = (batch, cfg.enc_seq, acfg.n_kv_heads, acfg.head_dim)
        return {
            "self": attn.attn_cache_spec(acfg, batch, smax, dtype),
            "cross": {"k": attn.TensorSpec(xshp, dtype),
                      "v": attn.TensorSpec(xshp, dtype)},
        }
    raise _unported(kind)
