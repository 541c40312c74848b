"""Attention mixers: GQA/MQA (RoPE, sliding window, softcap) and cross-attn.

The twin of ``repro.models.attention`` for the attention-family blocks.
Attention is *chunked*: an online softmax over static KV chunks, so no
``S x S`` score matrix is materialized, and a fully masked chunk pair is
never computed.  Scores and accumulators are float32 whatever the inputs'
dtype: the operands are upcast before each product, as ``repro``'s
``preferred_element_type=float32``.  Masked scores take ``NEG_INF``.

Conventions (``repro``'s):
  x          (B, S, d)
  q          (B, S, H, Dh);  k/v (B, S, Hkv, Dh)
  cache      {"k": (B, Smax, Hkv, Dh), "v": ...} + the position carried by
             the caller; decode is one unchunked product over Smax.

Query head ``h`` reads kv head ``h // rep`` (``q`` reshapes to
``(B, S, Hkv, rep, Dh)``).  MLA (DeepSeek-V3's multi-head latent
attention) has two computations: prefill materializes per-head K and V
from the latent and runs the chunked core with V padded to ``qk_dim``;
decode absorbs ``W_uk`` into the query and attends in the latent space
over a cache of ``(latent, k_rope)``.  Not ported:
``_sequence_parallel_qkv``, a sharding hint that is the identity on one
device; the sharded LM brings it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models.params import ParamDecl, ParamTable


class TensorSpec(NamedTuple):
    """Shape and dtype of a cache tensor (``jax.ShapeDtypeStruct``'s
    stand-in)."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    window: int | None = None  # sliding window (gemma2 local layers)
    softcap: float | None = None  # attn logit softcap (gemma2)
    use_rope: bool = True
    chunk_q: int = 1024
    chunk_k: int = 1024

    @property
    def rep(self) -> int:
        return self.n_heads // self.n_kv_heads


def attn_param_table(cfg: AttnConfig) -> ParamTable:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDecl((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDecl((d, hk, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDecl((d, hk, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDecl((h, dh, d), ("heads", "head_dim", "embed"), init="output",
                        fan_in=h * dh),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", x, w)``."""
    d, h, e = w.shape
    return common.matmul(x, w.reshape(d, h * e)).unflatten(-1, (h, e))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, wo)``."""
    h, e, d = wo.shape
    return common.matmul(o.flatten(-2), wo.reshape(h * e, d))


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core
# ---------------------------------------------------------------------------


def _chunk_skippable(cfg, q_lo, q_hi, k_lo, k_hi) -> bool:
    """Static: is the (q-chunk, k-chunk) pair fully masked?"""
    if cfg.causal and k_lo > q_hi:
        return True
    if cfg.window is not None and k_hi <= q_lo - cfg.window:
        return True
    return False


def _fit_chunk(s: int, c: int) -> int:
    """Largest divisor of ``s`` that is <= c (chunking odd sequence lengths
    like whisper's 1500 encoder frames)."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(
    cfg: AttnConfig,
    q: torch.Tensor,  # (B, Sq, H, Dh)
    k: torch.Tensor,  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,  # (B, Sk, Hkv, Dh)
    q_start: int = 0,
) -> torch.Tensor:
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    hkv, rep = cfg.n_kv_heads, cfg.rep
    scale = 1.0 / math.sqrt(dh)
    cq = _fit_chunk(sq, cfg.chunk_q)
    ck = _fit_chunk(sk, cfg.chunk_k)
    dev = q.device

    # (B, Hkv, rep, Sq, Dh) and (B, Hkv, Sk, Dh), float32 for the products.
    qg = q.reshape(b, sq, hkv, rep, dh).permute(0, 2, 3, 1, 4).float()
    kg = k.permute(0, 2, 1, 3).float()
    vg = v.permute(0, 2, 1, 3)
    out_chunks = []
    for qi in range(sq // cq):
        q_lo, q_hi = q_start + qi * cq, q_start + (qi + 1) * cq - 1
        qc = qg[:, :, :, qi * cq: (qi + 1) * cq].reshape(b, hkv, rep * cq, dh)
        m = torch.full((b, hkv, rep, cq), common.NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, rep, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep, cq, dh), dtype=torch.float32,
                          device=dev)
        q_pos = q_start + qi * cq + torch.arange(cq, device=dev)
        for ki in range(sk // ck):
            k_lo, k_hi = ki * ck, (ki + 1) * ck - 1
            if _chunk_skippable(cfg, q_lo, q_hi, k_lo, k_hi):
                continue
            kc = kg[:, :, ki * ck: (ki + 1) * ck]
            vc = vg[:, :, ki * ck: (ki + 1) * ck]
            s = (qc @ kc.transpose(-1, -2)).view(b, hkv, rep, cq, ck) * scale
            if cfg.softcap is not None:
                s = common.softcap(s, cfg.softcap)
            k_pos = ki * ck + torch.arange(ck, device=dev)
            if cfg.causal:
                mask = common.causal_window_mask(q_pos, k_pos, cfg.window)
            elif cfg.window is not None:
                mask = torch.abs(k_pos[None, :] - q_pos[:, None]) < cfg.window
            else:
                mask = None
            if mask is not None:
                s = torch.where(mask, s, common.NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            pv = (p.to(vc.dtype).float().view(b, hkv, rep * cq, ck)
                  @ vc.float()).view(b, hkv, rep, cq, dh)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        out_chunks.append(
            out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, dh).to(q.dtype))
    return torch.cat(out_chunks, dim=1) if len(out_chunks) > 1 else out_chunks[0]


def _attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rep: int, softcap: float | None = None,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """One query a sequence against a whole cache, unchunked: q (B, 1, H, Dh),
    k/v (B, Sk, Hkv, Dh), ``valid`` an (Sk,) mask.  Returns (B, 1, H, Dh) in
    q's dtype."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qr = q.reshape(b, hkv, rep, dh).float()
    s = (qr @ k.permute(0, 2, 3, 1).float()) * scale  # (B, Hkv, rep, Sk)
    if softcap is not None:
        s = common.softcap(s, softcap)
    if valid is not None:
        s = torch.where(valid, s, common.NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p.to(v.dtype).float() @ v.permute(0, 2, 1, 3).float()
    return out.reshape(b, 1, h, dh).to(q.dtype)


def decode_attention(
    cfg: AttnConfig,
    q: torch.Tensor,  # (B, 1, H, Dh)
    k_cache: torch.Tensor,  # (B, Smax, Hkv, Dh)
    v_cache: torch.Tensor,
    pos: int,  # current position (same for the batch)
) -> torch.Tensor:
    """Positions ``<= pos`` (and, with a window, ``> pos - window``) of the
    whole ``Smax`` cache: the cache is not a ring buffer."""
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = k_pos <= pos
    if cfg.window is not None:
        valid = torch.logical_and(valid, k_pos > pos - cfg.window)
    return _attend_cache(q, k_cache, v_cache, cfg.rep, cfg.softcap, valid)


# ---------------------------------------------------------------------------
# GQA self-attention block mixer
# ---------------------------------------------------------------------------


def self_attention(cfg: AttnConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor):
    """Training / prefill. Returns (out, kv) so callers may fill a cache."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(cfg, q, k, v)
    return _out(out, p["wo"]), (k, v)


def self_attention_decode(cfg: AttnConfig, p: dict, x: torch.Tensor,
                          cache: dict, pos: int):
    """Single-token decode; the cache entries at ``pos`` are written in
    place (in the cache's dtype)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.use_rope:
        posb = torch.full((x.shape[0], 1), pos, device=x.device)
        q = common.apply_rope(q, posb, cfg.rope_theta)
        k = common.apply_rope(k, posb, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(cfg, q, cache["k"], cache["v"], pos)
    return _out(out, p["wo"]), cache


def attn_cache_spec(cfg: AttnConfig, batch: int, smax: int, dtype):
    shp = (batch, smax, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shp, dtype), "v": TensorSpec(shp, dtype)}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder, vision-LM image layers)
# ---------------------------------------------------------------------------


def cross_attention(cfg: AttnConfig, p: dict, x: torch.Tensor,
                    kv_src: torch.Tensor):
    """kv_src: (B, Se, d) encoder/vision states. Bidirectional over kv_src."""
    q = _project(x, p["wq"])
    k = _project(kv_src, p["wk"])
    v = _project(kv_src, p["wv"])
    xcfg = dataclasses.replace(cfg, causal=False, window=None, use_rope=False)
    se = k.shape[1]
    ck = se if se < xcfg.chunk_k else xcfg.chunk_k
    while se % ck:
        ck -= 1
    xcfg = dataclasses.replace(xcfg, chunk_k=ck,
                               chunk_q=min(xcfg.chunk_q, x.shape[1]))
    out = chunked_attention(xcfg, q, k, v)
    return _out(out, p["wo"]), (k, v)


def cross_attention_cached(cfg: AttnConfig, p: dict, x: torch.Tensor,
                           cache: dict):
    """Decode-side cross-attn against precomputed (k, v): no mask, no
    softcap (``repro``'s)."""
    q = _project(x, p["wq"])
    out = _attend_cache(q, cache["k"], cache["v"], cfg.rep)
    return _out(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0
    chunk_q: int = 1024
    chunk_k: int = 1024

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_param_table(cfg: MLAConfig) -> ParamTable:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wdq": ParamDecl((d, cfg.q_lora_rank), ("embed", "q_lora")),
        "q_norm": ParamDecl((cfg.q_lora_rank,), ("q_lora",), init="zeros"),
        "wuq": ParamDecl((cfg.q_lora_rank, h, cfg.qk_dim),
                         ("q_lora", "heads", "head_dim")),
        "wdkv": ParamDecl((d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                          ("embed", "kv_lora")),
        "kv_norm": ParamDecl((cfg.kv_lora_rank,), ("kv_lora",), init="zeros"),
        "wuk": ParamDecl((cfg.kv_lora_rank, h, cfg.qk_nope_dim),
                         ("kv_lora", "heads", "head_dim")),
        "wuv": ParamDecl((cfg.kv_lora_rank, h, cfg.v_dim),
                         ("kv_lora", "heads", "head_dim")),
        "wo": ParamDecl((h, cfg.v_dim, d), ("heads", "head_dim", "embed"),
                        init="output", fan_in=h * cfg.v_dim),
    }


def _mla_q(cfg: MLAConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    ql = common.rms_norm(common.matmul(x, p["wdq"]), p["q_norm"])
    q = _project(ql, p["wuq"])
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = common.apply_rope(q[..., cfg.qk_nope_dim:], positions,
                               cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg: MLAConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    dkv = common.matmul(x, p["wdkv"])
    latent = common.rms_norm(dkv[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = common.apply_rope(
        dkv[..., cfg.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta
    )[:, :, 0]  # (B, S, dr) — single shared rope key
    return latent, k_rope


def mla_attention(cfg: MLAConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor):
    """Prefill/train: per-head K and V materialized from the latent, through
    the chunked core with V padded to ``qk_dim``.  Returns (y, the cache
    payload ``(latent, k_rope)``)."""
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = _project(latent, p["wuk"])
    v = _project(latent, p["wuv"])
    h = cfg.n_heads
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], h,
                                            cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    acfg = AttnConfig(
        d_model=cfg.d_model, n_heads=h, n_kv_heads=h, head_dim=cfg.qk_dim,
        use_rope=False, chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k,
    )
    v_p = torch.nn.functional.pad(v, (0, cfg.qk_dim - cfg.v_dim))
    out = chunked_attention(acfg, q, k, v_p)[..., : cfg.v_dim]
    return _out(out, p["wo"]), (latent, k_rope)


def mla_attention_decode(cfg: MLAConfig, p: dict, x: torch.Tensor,
                         cache: dict, pos: int):
    """Absorbed decode: scores and values live in the latent space, and the
    cache is ``(latent, k_rope)`` only (MLA's memory win).  The cache
    entries at ``pos`` are written in place (in the cache's dtype)."""
    b = x.shape[0]
    posb = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, posb)  # (B,1,H,*)
    latent_new, k_rope_new = _mla_latent(cfg, p, x, posb)
    cache["latent"][:, pos] = latent_new[:, 0].to(cache["latent"].dtype)
    cache["k_rope"][:, pos] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    latent, k_rope = cache["latent"], cache["k_rope"]
    # Absorb W_uk into the query: q_abs (B,H,r)
    q_abs = common.einsum("bhe,rhe->bhr", q_nope[:, 0], p["wuk"])
    s = common.einsum("bhr,bkr->bhk", q_abs, latent, f32=True)
    s = s + common.einsum("bhe,bke->bhk", q_rope[:, 0], k_rope, f32=True)
    s = s / math.sqrt(cfg.qk_dim)
    k_posn = torch.arange(latent.shape[1], device=x.device)
    s = torch.where((k_posn <= pos)[None, None], s, common.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = common.einsum("bhk,bkr->bhr", pr.to(latent.dtype), latent,
                 f32=True).to(x.dtype)
    out = common.einsum("bhr,rhe->bhe", o_lat, p["wuv"])
    y = common.einsum("bhe,hed->bd", out, p["wo"])[:, None]
    return y, cache


def mla_cache_spec(cfg: MLAConfig, batch: int, smax: int, dtype):
    return {
        "latent": TensorSpec((batch, smax, cfg.kv_lora_rank), dtype),
        "k_rope": TensorSpec((batch, smax, cfg.qk_rope_dim), dtype),
    }
