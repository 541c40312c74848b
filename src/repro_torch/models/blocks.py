"""Block assembly: ModelConfig block-kind -> params, apply, decode, cache.

The twin of ``repro.models.blocks``, every kind of it.  A "block" is one
residual unit.  Attention-family blocks (``attn``, ``attn_local``,
``attn_bidir``, ``attn_moe``, ``attn_shared``, ``mla``, ``mla_moe``,
``cross``, ``dec_cross``) are a pre-norm mixer plus a pre-norm MLP or MoE;
recurrent blocks (``mamba``, ``mlstm``, ``slstm``) are self-contained.  All
functions are pure but for decode's cache writes; parameters are flat
``{path: tensor}`` dicts scoped by the caller.  A kind ``repro`` does not
know raises ``ValueError``, as in ``repro``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, moe, ssm, xlstm
from repro_torch.models.params import (
    ParamDecl,
    ParamTable,
    merge_tables,
    prefix_table,
)

#: Self-attention kinds (``repro``'s ``_ATTN_KINDS``).
_ATTN_KINDS = ("attn", "attn_local", "attn_bidir", "attn_moe", "attn_shared")


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind {kind!r}")


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


def mla_config(cfg: ModelConfig) -> attn.MLAConfig:
    return attn.MLAConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim,
        v_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        chunk_q=cfg.attn_chunk,
        chunk_k=cfg.attn_chunk,
    )


def mlp_config(cfg: ModelConfig) -> mlp.MLPConfig:
    return mlp.MLPConfig(cfg.d_model, cfg.d_ff, cfg.activation)


def moe_config(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff or cfg.d_ff,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        n_shared=cfg.n_shared_experts,
    )


def mamba_config(cfg: ModelConfig) -> ssm.Mamba2Config:
    return ssm.Mamba2Config(
        d_model=cfg.d_model, d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
    )


def mlstm_config(cfg: ModelConfig) -> xlstm.MLSTMConfig:
    return xlstm.MLSTMConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk
    )


def slstm_config(cfg: ModelConfig) -> xlstm.SLSTMConfig:
    return xlstm.SLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_kv_heads)


def _norm(name: str, d: int) -> ParamTable:
    return {name: ParamDecl((d,), ("embed",), init="zeros")}


# ---------------------------------------------------------------------------
# Param tables per block kind
# ---------------------------------------------------------------------------


def block_param_table(cfg: ModelConfig, kind: str) -> ParamTable:
    d = cfg.d_model
    if kind in _ATTN_KINDS or kind in ("mla", "mla_moe"):
        mixer = (attn.mla_param_table(mla_config(cfg))
                 if kind in ("mla", "mla_moe")
                 else attn.attn_param_table(attn_config(cfg, kind)))
        t = merge_tables(_norm("ln1", d), prefix_table("attn", mixer),
                         _norm("ln2", d))
        if kind in ("attn_moe", "mla_moe"):
            return merge_tables(
                t, prefix_table("moe", moe.moe_param_table(moe_config(cfg))))
        return merge_tables(
            t, prefix_table("mlp", mlp.mlp_param_table(mlp_config(cfg))))
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
    if kind == "mamba":
        return merge_tables(
            _norm("ln1", d),
            prefix_table("mamba", ssm.mamba2_param_table(mamba_config(cfg))),
        )
    if kind == "mlstm":
        return merge_tables(
            _norm("ln1", d),
            prefix_table("mlstm", xlstm.mlstm_param_table(mlstm_config(cfg))),
        )
    if kind == "slstm":
        return prefix_table("slstm", xlstm.slstm_param_table(slstm_config(cfg)))
    raise _unknown(kind)


def _sub(p: dict, prefix: str) -> dict:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                ctx: dict):
    """Returns (x, aux_loss, kv) — kv is the prefill cache payload.  Only
    the MoE kinds have an auxiliary loss (the others' is 0)."""
    eps = cfg.norm_eps
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _ATTN_KINDS or kind in ("mla", "mla_moe"):
        xn = common.rms_norm(x, p["ln1"], eps)
        if kind in ("mla", "mla_moe"):
            h, kv = attn.mla_attention(mla_config(cfg), _sub(p, "attn"), xn,
                                       ctx["positions"])
        else:
            h, kv = attn.self_attention(attn_config(cfg, kind),
                                        _sub(p, "attn"), xn, ctx["positions"])
        x = x + h
        h, aux = _ffn(cfg, kind, p, common.rms_norm(x, p["ln2"], eps))
        return x + h, (zero if aux is None else aux), kv
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
    if kind == "mamba":
        h, state = ssm.mamba2(mamba_config(cfg), _sub(p, "mamba"),
                              common.rms_norm(x, p["ln1"], eps))
        return x + h, zero, state
    if kind == "mlstm":
        h, state = xlstm.mlstm(mlstm_config(cfg), _sub(p, "mlstm"),
                               common.rms_norm(x, p["ln1"], eps))
        return x + h, zero, state
    if kind == "slstm":
        y, carry = xlstm.slstm(slstm_config(cfg), _sub(p, "slstm"), x)
        return y, zero, carry
    raise _unknown(kind)


def _ffn(cfg: ModelConfig, kind: str, p: dict, xn: torch.Tensor):
    """The MoE (kinds ``*_moe``) or the MLP after an attention mixer:
    ``(out, aux)``, aux None for the MLP."""
    if kind in ("attn_moe", "mla_moe"):
        return moe.moe(moe_config(cfg), _sub(p, "moe"), xn)
    return mlp.mlp(mlp_config(cfg), _sub(p, "mlp"), xn), None


# ---------------------------------------------------------------------------
# Decode (one token, cache update)
# ---------------------------------------------------------------------------


def decode_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                 cache, ctx: dict):
    """One token through the block; its cache is updated in place:
    self-attention and MLA caches at ``ctx["pos"]``, the recurrent blocks'
    state whole.  Cross-attention caches are only read.  A MoE routes the
    batch's tokens as one group (``repro``'s decode)."""
    eps = cfg.norm_eps
    pos = ctx["pos"]
    if kind in _ATTN_KINDS or kind in ("mla", "mla_moe"):
        xn = common.rms_norm(x, p["ln1"], eps)
        if kind in ("mla", "mla_moe"):
            h, cache_new = attn.mla_attention_decode(
                mla_config(cfg), _sub(p, "attn"), xn, cache, pos)
        else:
            h, cache_new = attn.self_attention_decode(
                attn_config(cfg, kind), _sub(p, "attn"), xn, cache, pos)
        x = x + h
        h, _ = _ffn(cfg, kind, p, common.rms_norm(x, p["ln2"], eps))
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
    if kind == "mamba":
        h, new = ssm.mamba2_decode(mamba_config(cfg), _sub(p, "mamba"),
                                   common.rms_norm(x, p["ln1"], eps), cache)
        return x + h, _write(cache, new)
    if kind == "mlstm":
        h, new = xlstm.mlstm_decode(mlstm_config(cfg), _sub(p, "mlstm"),
                                    common.rms_norm(x, p["ln1"], eps), cache)
        return x + h, _write(cache, new)
    if kind == "slstm":
        y, new = xlstm.slstm_decode(slstm_config(cfg), _sub(p, "slstm"), x,
                                    cache)
        return y, _write(cache, new)
    raise _unknown(kind)


def _write(cache, new):
    """Copy the tree ``new`` into the cache tensors of the same tree (each
    in its own dtype); returns ``cache``."""
    if isinstance(cache, dict):
        for k in cache:
            _write(cache[k], new[k])
    elif isinstance(cache, list):
        for c, n in zip(cache, new):
            _write(c, n)
    else:
        cache.copy_(new)
    return cache


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------


def block_cache_spec(cfg: ModelConfig, kind: str, batch: int, smax: int, dtype):
    if kind in _ATTN_KINDS:
        return attn.attn_cache_spec(attn_config(cfg, kind), batch, smax, dtype)
    if kind in ("mla", "mla_moe"):
        return attn.mla_cache_spec(mla_config(cfg), batch, smax, dtype)
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
    if kind == "mamba":
        return ssm.mamba2_cache_spec(mamba_config(cfg), batch, dtype)
    if kind == "mlstm":
        return xlstm.mlstm_cache_spec(mlstm_config(cfg), batch, dtype)
    if kind == "slstm":
        return xlstm.slstm_cache_spec(slstm_config(cfg), batch, dtype)
    raise _unknown(kind)
