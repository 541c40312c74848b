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
``(B, S, Hkv, rep, Dh)``).  Not ported: ``repro``'s MLA (multi-head latent
attention) and ``_sequence_parallel_qkv``, a sharding hint that is the
identity on one device; both wait for their own slices.
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
