"""Block assembly: ModelConfig block-kind -> params, apply, decode, cache.

The twin of ``repro.models.blocks``, every kind of it.  A "block" is one
residual unit.  Attention-family blocks (``attn``, ``attn_local``,
``attn_bidir``, ``attn_moe``, ``attn_shared``, ``mla``, ``mla_moe``,
``cross``, ``dec_cross``) are a pre-norm mixer plus a pre-norm MLP or MoE;
recurrent blocks (``mamba``, ``mlstm``, ``slstm``) are self-contained.  All
functions are pure but for decode's cache writes; parameters are flat
``{path: tensor}`` dicts scoped by the caller.  A kind ``repro`` does not
know raises ``ValueError``, as in ``repro``.  The ``*_rows`` functions run
the blocks over a mesh's data rows (``train.steps.build_programs``).
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
from repro_torch.sharding.placement import Split

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
    the MoE kinds have an auxiliary loss (the others' is 0); they add their
    dropped (token, choice) pairs to ``ctx["stats"]`` when it is given
    (``moe.moe``)."""
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
        h, aux = _ffn(cfg, kind, p, common.rms_norm(x, p["ln2"], eps),
                      ctx.get("stats"))
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


def _ffn(cfg: ModelConfig, kind: str, p: dict, xn: torch.Tensor,
         stats: dict | None = None):
    """The MoE (kinds ``*_moe``) or the MLP after an attention mixer:
    ``(out, aux)``, aux None for the MLP."""
    if kind in ("attn_moe", "mla_moe"):
        return moe.moe(moe_config(cfg), _sub(p, "moe"), xn, stats)
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
        h, _ = _ffn(cfg, kind, p, common.rms_norm(x, p["ln2"], eps),
                    ctx.get("stats"))
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


# ---------------------------------------------------------------------------
# Over a mesh's data rows
# ---------------------------------------------------------------------------
#
# ``ps[r]`` is row ``r``'s ``{path: Split}`` (``sharding.placement``),
# ``xs[r]`` its activations on its first device, ``rows[r]`` its devices.
# The attention mixers split by heads or sequence (``attention.*_row``), the
# MLPs by columns (``mlp.mlp_row``), the MoE by experts (``moe.moe_rows``);
# the recurrent kinds gather their weights (and caches) onto the row's first
# device and run as on one device.  A row of one device (a model axis of 1)
# runs the unsharded blocks on its shards, the MoE's routing still over
# every row.

_MOE_KINDS = ("attn_moe", "mla_moe")


def _whole(p: dict) -> dict:
    return {k: v.full() for k, v in p.items()}


def _parts0(cache):
    """A one-device row's cache tree: each :class:`Split`'s one part (views
    of the shards, written in place)."""
    return _map_splits(lambda s: s.parts[0], cache)


def _mixer_row(cfg: ModelConfig, kind: str, p: dict, xn, ctx, devices):
    if len(devices) == 1:
        if kind in ("mla", "mla_moe"):
            return attn.mla_attention(mla_config(cfg), _whole(_sub(p, "attn")),
                                      xn, ctx["positions"])
        return attn.self_attention(attn_config(cfg, kind),
                                   _whole(_sub(p, "attn")), xn,
                                   ctx["positions"])
    if kind in ("mla", "mla_moe"):
        return attn.mla_attention_row(mla_config(cfg), _sub(p, "attn"), xn,
                                      ctx["positions"], devices)
    return attn.attention_row(attn_config(cfg, kind), _sub(p, "attn"), xn,
                              ctx["positions"], devices)


def _mixer_decode_row(cfg, kind, p, xn, cache, ctx, devices):
    if len(devices) == 1:
        if kind in ("mla", "mla_moe"):
            return attn.mla_attention_decode(mla_config(cfg),
                                             _whole(_sub(p, "attn")), xn,
                                             _parts0(cache), ctx["pos"])
        return attn.self_attention_decode(attn_config(cfg, kind),
                                          _whole(_sub(p, "attn")), xn,
                                          _parts0(cache), ctx["pos"])
    if kind in ("mla", "mla_moe"):
        return attn.mla_attention_decode_row(mla_config(cfg), _sub(p, "attn"),
                                             xn, cache, ctx["pos"], devices)
    return attn.attention_decode_row(attn_config(cfg, kind), _sub(p, "attn"),
                                     xn, cache, ctx["pos"], devices)


def apply_block_rows(cfg: ModelConfig, kind: str, ps: list, xs: list,
                     ctxs: list, rows: list):
    """:func:`apply_block` over the rows: ``(xs, aux, kvs)``, a payload per
    row (an attention's k and v may be :class:`Split`s by heads)."""
    eps = cfg.norm_eps
    if kind in _MOE_KINDS:
        mid, hs, kvs = [], [], []
        for p, x, ctx, devices in zip(ps, xs, ctxs, rows):
            h, kv = _mixer_row(cfg, kind, p,
                               common.rms_norm(x, p["ln1"].full(), eps), ctx,
                               devices)
            x = x + h
            mid.append(x)
            hs.append(common.rms_norm(x, p["ln2"].full(), eps))
            kvs.append(kv)
        ys, aux = moe.moe_rows(moe_config(cfg), [_sub(p, "moe") for p in ps],
                               hs, rows, ctxs[0].get("stats"))
        return [x + y for x, y in zip(mid, ys)], aux, kvs
    out = [_apply_block_row(cfg, kind, p, x, ctx, devices)
           for p, x, ctx, devices in zip(ps, xs, ctxs, rows)]
    zero = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    return [o[0] for o in out], zero, [o[1] for o in out]


def _apply_block_row(cfg, kind, p, x, ctx, devices):
    eps = cfg.norm_eps
    mcfg = mlp_config(cfg)
    if len(devices) == 1 and kind not in _MOE_KINDS:
        x, _, kv = apply_block(cfg, kind, _whole(p), x, ctx)
        return x, kv
    if kind in _ATTN_KINDS or kind == "mla":
        h, kv = _mixer_row(cfg, kind, p,
                           common.rms_norm(x, p["ln1"].full(), eps), ctx,
                           devices)
        x = x + h
        h = mlp.mlp_row(mcfg, _sub(p, "mlp"),
                        common.rms_norm(x, p["ln2"].full(), eps), devices)
        return x + h, kv
    if kind == "cross":
        h, kv = attn.attention_row(
            attn_config(cfg, kind), _sub(p, "xattn"),
            common.rms_norm(x, p["ln1"].full(), eps), None, devices,
            kv_src=ctx["kv_src"])
        x = x + torch.tanh(p["xgate"].full()).to(x.dtype) * h
        h = mlp.mlp_row(mcfg, _sub(p, "mlp"),
                        common.rms_norm(x, p["ln2"].full(), eps), devices)
        return x + h, kv
    if kind == "dec_cross":
        acfg = attn_config(cfg, kind)
        h, kv_self = attn.attention_row(
            acfg, _sub(p, "attn"), common.rms_norm(x, p["ln1"].full(), eps),
            ctx["positions"], devices)
        x = x + h
        h, kv_cross = attn.attention_row(
            acfg, _sub(p, "xattn"), common.rms_norm(x, p["lnx"].full(), eps),
            None, devices, kv_src=ctx["kv_src"])
        x = x + h
        h = mlp.mlp_row(mcfg, _sub(p, "mlp"),
                        common.rms_norm(x, p["ln2"].full(), eps), devices)
        return x + h, (kv_self, kv_cross)
    if kind in ("mamba", "mlstm", "slstm"):
        x, _, kv = apply_block(cfg, kind, _whole(p), x, ctx)
        return x, kv
    raise _unknown(kind)


def decode_block_rows(cfg: ModelConfig, kind: str, ps: list, xs: list,
                      caches: list, ctx: dict, rows: list) -> list:
    """:func:`decode_block` over the rows, each row's cache a tree of
    :class:`Split`s updated in place.  Returns the rows' outputs."""
    eps = cfg.norm_eps
    if kind in _MOE_KINDS:
        mid, hs = [], []
        for p, x, cache, devices in zip(ps, xs, caches, rows):
            h, _ = _mixer_decode_row(cfg, kind, p,
                                     common.rms_norm(x, p["ln1"].full(), eps),
                                     cache, ctx, devices)
            x = x + h
            mid.append(x)
            hs.append(common.rms_norm(x, p["ln2"].full(), eps))
        ys, _ = moe.moe_rows(moe_config(cfg), [_sub(p, "moe") for p in ps],
                             hs, rows, ctx.get("stats"))
        return [x + y for x, y in zip(mid, ys)]
    return [_decode_block_row(cfg, kind, p, x, cache, ctx, devices)
            for p, x, cache, devices in zip(ps, xs, caches, rows)]


def _decode_block_row(cfg, kind, p, x, cache, ctx, devices):
    eps = cfg.norm_eps
    mcfg = mlp_config(cfg)
    if len(devices) == 1 and kind not in ("mamba", "mlstm", "slstm"):
        return decode_block(cfg, kind, _whole(p), x, _parts0(cache), ctx)[0]
    if kind in _ATTN_KINDS or kind == "mla":
        h, _ = _mixer_decode_row(cfg, kind, p,
                                 common.rms_norm(x, p["ln1"].full(), eps),
                                 cache, ctx, devices)
        x = x + h
        return x + mlp.mlp_row(mcfg, _sub(p, "mlp"),
                               common.rms_norm(x, p["ln2"].full(), eps),
                               devices)
    if kind in ("cross", "dec_cross"):
        acfg = attn_config(cfg, kind)
        xcache = cache
        if kind == "dec_cross":
            h, _ = attn.attention_decode_row(
                acfg, _sub(p, "attn"), common.rms_norm(x, p["ln1"].full(), eps),
                cache["self"], ctx["pos"], devices)
            x = x + h
            xcache = cache["cross"]
        norm = "lnx" if kind == "dec_cross" else "ln1"
        h, _ = attn.attention_decode_row(
            acfg, _sub(p, "xattn"), common.rms_norm(x, p[norm].full(), eps),
            xcache, ctx["pos"], devices, cross=True)
        if kind == "cross":
            h = torch.tanh(p["xgate"].full()).to(x.dtype) * h
        x = x + h
        return x + mlp.mlp_row(mcfg, _sub(p, "mlp"),
                               common.rms_norm(x, p["ln2"].full(), eps),
                               devices)
    if kind in ("mamba", "mlstm", "slstm"):
        whole = _map_splits(lambda s: s.full(), cache)
        x, whole = decode_block(cfg, kind, _whole(p), x, whole, ctx)
        _map_splits(lambda s, w: s.write(w), cache, whole)
        return x
    raise _unknown(kind)


def _map_splits(fn, tree, *rest):
    """``fn`` over the :class:`Split` leaves of a cache tree."""
    if isinstance(tree, dict):
        return {k: _map_splits(fn, v, *(o[k] for o in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_splits(fn, v, *(o[i] for o in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def payload_to_split_cache(kind: str, payload, cache, s: int):
    """Write one row's prefill payload into its cache :class:`Split`s
    (positions ``[0, s)`` of the self-attention and latent caches; the
    cross-attention caches and recurrent states whole)."""
    def put(split, value, dim=1):
        if isinstance(value, Split):
            for part, v in zip(split.parts, value.parts):
                part.narrow(dim, 0, v.shape[dim]).copy_(v)
        else:
            split.write(value, dim, 0)

    if kind in _ATTN_KINDS or kind == "cross":
        put(cache["k"], payload[0])
        put(cache["v"], payload[1])
    elif kind in ("mla", "mla_moe"):
        put(cache["latent"], payload[0])
        put(cache["k_rope"], payload[1])
    elif kind == "dec_cross":
        payload_to_split_cache("attn", payload[0], cache["self"], s)
        payload_to_split_cache("cross", payload[1], cache["cross"], s)
    elif kind in ("mamba", "mlstm"):
        _map_splits(lambda sp, v: sp.write(v, 0, 0), cache, payload)
    elif kind == "slstm":
        _map_splits(lambda sp, v: sp.write(v, 0, 0), cache,
                    {"carry": list(payload)})
    else:
        raise _unknown(kind)
