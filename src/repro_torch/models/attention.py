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
over a cache of ``(latent, k_rope)``.

On a mesh (``train.steps.build_programs``) each data row runs the
``*_row`` functions below over its model-axis devices, making
``repro``'s choice (:func:`_sequence_parallel_qkv`): when the model axis
divides the heads, each device runs its heads (q, k and v by heads, and
its part of the output projection summed on the row's first device, in float32
before one rounding, as the unsharded product accumulates);
otherwise each device runs a slice of the query sequence against the whole
of K and V.  Decode against a cache split by heads runs each device's
heads; against a cache split on the sequence (the KV heads do not divide,
and MLA's latent always) each device attends over its slice and the
partial softmaxes are combined by their log-sum-exp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models import common
from repro_torch.models.params import ParamDecl, ParamTable
from repro_torch.sharding import hints
from repro_torch.sharding.placement import Split


def _sequence_parallel_qkv(cfg, q, k, v):
    """``repro``'s context-parallel fallback for head counts indivisible by
    the model axis: heads on ``model`` when they divide it, else the query
    sequence.  The layout requests are recorded (``hints.constrain``) and
    the tensors returned as they are; the mesh programs make the same
    choice (:func:`heads_split`)."""
    if heads_split(cfg, hints.model_axis_size()):
        if cfg.n_kv_heads % hints.model_axis_size() == 0:
            k = hints.constrain(k, "data", None, "model", None)
            v = hints.constrain(v, "data", None, "model", None)
        q = hints.constrain(q, "data", None, "model", None)
        return q, k, v
    q = hints.constrain(q, "data", "model", None, None)
    k = hints.constrain(k, "data", "model", None, None)
    v = hints.constrain(v, "data", "model", None, None)
    return q, k, v


def heads_split(cfg, model_size: int) -> bool:
    """Does a model axis of ``model_size`` split ``cfg``'s heads?"""
    return cfg.n_heads % model_size == 0


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


def _out(o: torch.Tensor, wo: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, wo)`` (with ``f32``, a partial sum in
    at least float32: ``common.matmul``)."""
    h, e, d = wo.shape
    return common.matmul(o.flatten(-2), wo.reshape(h * e, d), f32=f32)


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
    q, k, v = _sequence_parallel_qkv(cfg, q, k, v)
    out = chunked_attention(cfg, q, k, v)
    return _out(out, p["wo"]), (k, v)


def self_attention_decode(cfg: AttnConfig, p: dict, x: torch.Tensor,
                          cache: dict, pos: int, f32: bool = False):
    """Single-token decode; the cache entries at ``pos`` are written in
    place (in the cache's dtype).  ``f32``: the output projection as a
    partial sum (:func:`_out`)."""
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
    return _out(out, p["wo"], f32), cache


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
    out = chunked_attention(_cross_cfg(cfg, x.shape[1], k.shape[1]), q, k, v)
    return _out(out, p["wo"]), (k, v)


def _cross_cfg(cfg: AttnConfig, sq: int, se: int) -> AttnConfig:
    """The cross-attention core's config: bidirectional, no RoPE, chunks
    fitted to ``sq`` queries and ``se`` encoder positions."""
    xcfg = dataclasses.replace(cfg, causal=False, window=None, use_rope=False)
    ck = se if se < xcfg.chunk_k else xcfg.chunk_k
    while se % ck:
        ck -= 1
    return dataclasses.replace(xcfg, chunk_k=ck, chunk_q=min(xcfg.chunk_q, sq))


def cross_attention_cached(cfg: AttnConfig, p: dict, x: torch.Tensor,
                           cache: dict, f32: bool = False):
    """Decode-side cross-attn against precomputed (k, v): no mask, no
    softcap (``repro``'s).  ``f32`` as in :func:`self_attention_decode`."""
    q = _project(x, p["wq"])
    out = _attend_cache(q, cache["k"], cache["v"], cfg.rep)
    return _out(out, p["wo"], f32), cache


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
    out, kv = _mla_heads(cfg, p, x, positions)
    return _out(out, p["wo"]), kv


def _mla_heads(cfg: MLAConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor):
    """:func:`mla_attention` up to its output projection: ``(out (B, S, H,
    v_dim), (latent, k_rope))``."""
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
    q, k, v = _sequence_parallel_qkv(acfg, q, k, v)
    v_p = torch.nn.functional.pad(v, (0, cfg.qk_dim - cfg.v_dim))
    out = chunked_attention(acfg, q, k, v_p)[..., : cfg.v_dim]
    return out, (latent, k_rope)


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


# ---------------------------------------------------------------------------
# Over a mesh row: the model axis split by heads or by query sequence
# ---------------------------------------------------------------------------
#
# ``p`` maps each weight to its :class:`~repro_torch.sharding.placement.
# Split` over the row's devices (part ``m`` on ``devices[m]``); ``x`` lies on
# the row's first device, where every result is summed or concatenated.


def _head_shard(cfg: AttnConfig, p: dict, m: int, msz: int):
    """Device ``m``'s config and weights under the head split: its query
    heads, and its KV heads (split alike when they divide, else the run of
    the replicated ``wk``/``wv`` that its query heads read)."""
    h_loc = cfg.n_heads // msz
    wk, wv = p["wk"].parts[m], p["wv"].parts[m]
    if p["wk"].dim is not None:
        kv_loc = cfg.n_kv_heads // msz
    else:
        rep = cfg.rep
        if h_loc % rep and rep % h_loc:
            raise NotImplementedError(
                f"{cfg.n_heads} heads over {msz} devices with {rep} query "
                f"heads a KV head")
        lo, hi = m * h_loc // rep, ((m + 1) * h_loc - 1) // rep + 1
        wk, wv = wk[:, lo:hi], wv[:, lo:hi]
        kv_loc = hi - lo
    return (dataclasses.replace(cfg, n_heads=h_loc, n_kv_heads=kv_loc),
            {"wq": p["wq"].parts[m], "wk": wk, "wv": wv,
             "wo": p["wo"].parts[m]})


def _kv(cfg: AttnConfig, p: dict, src, positions):
    k, v = _project(src, p["wk"]), _project(src, p["wv"])
    if cfg.use_rope:
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _qkv(cfg: AttnConfig, p: dict, x, src, positions):
    q = _project(x, p["wq"])
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
    return (q, *_kv(cfg, p, src, positions))


def attention_row(cfg: AttnConfig, p: dict, x, positions, devices,
                  kv_src=None):
    """:func:`self_attention` (``kv_src`` None) or :func:`cross_attention`
    over a row.  Returns ``(y, (k, v))``: under the head split with the KV
    heads split too, k and v are :class:`Split`s by heads (the cache's
    layout), else whole tensors."""
    msz = len(devices)
    first = x.device
    src = x if kv_src is None else kv_src
    acfg = cfg if kv_src is None else _cross_cfg(cfg, x.shape[1], src.shape[1])
    if not heads_split(cfg, msz):
        return _seq_split_attention(acfg, p, x, src, positions, devices)
    ys, ks, vs = [], [], []
    for m, dev in enumerate(devices):
        cfg_m, p_m = _head_shard(acfg, p, m, msz)
        q, k, v = _qkv(cfg_m, p_m, x.to(dev), src.to(dev),
                       None if positions is None else positions.to(dev))
        ys.append(_out(chunked_attention(cfg_m, q, k, v), p_m["wo"], f32=True))
        ks.append(k)
        vs.append(v)
    y = common.sum_partials(ys, first, x.dtype)
    if p["wk"].dim is not None:
        return y, (Split(tuple(ks), 2), Split(tuple(vs), 2))
    whole = {n: p[n].parts[0] for n in ("wk", "wv")}
    return y, _kv(acfg, whole, src, positions)


def _seq_split_attention(cfg: AttnConfig, p: dict, x, src, positions,
                         devices):
    """The heads do not divide the model axis (every weight is whole on each
    device): device ``m`` projects its slice of the sequence, K and V are
    gathered, and it attends its query slice against the whole of them."""
    msz = len(devices)
    first = x.device
    xs = torch.tensor_split(x, msz, dim=1)
    srcs = torch.tensor_split(src, msz, dim=1)
    pos = ([None] * msz if positions is None
           else torch.tensor_split(positions, msz, dim=1))
    ks, vs = [], []
    for m, dev in enumerate(devices):
        w = {n: p[n].parts[m] for n in ("wk", "wv")}
        k, v = _kv(cfg, w, srcs[m].to(dev),
                   None if pos[m] is None else pos[m].to(dev))
        ks.append(k.to(first))
        vs.append(v.to(first))
    k, v = torch.cat(ks, dim=1), torch.cat(vs, dim=1)
    ys, start = [], 0
    for m, dev in enumerate(devices):
        q = _project(xs[m].to(dev), p["wq"].parts[m])
        if cfg.use_rope:
            q = common.apply_rope(q, pos[m].to(dev), cfg.rope_theta)
        o = chunked_attention(cfg, q, k.to(dev), v.to(dev), q_start=start)
        ys.append(_out(o, p["wo"].parts[m]).to(first))
        start += xs[m].shape[1]
    return torch.cat(ys, dim=1), (k, v)


def _partial(s: torch.Tensor, v: torch.Tensor):
    """One shard's part of a softmax over its keys: float32 scores ``s``
    (..., Sk) against values ``v`` (..., Sk, D).  Returns ``(acc, max,
    sum)``: the unnormalized output, the scores' max and the sum of their
    exponentials."""
    mx = torch.amax(s, dim=-1)
    e = torch.exp(s - mx[..., None])
    return (e.to(v.dtype).float() @ v.float()), mx, torch.sum(e, dim=-1)


def _combine(first, partials) -> torch.Tensor:
    """The softmax-weighted output from the shards' :func:`_partial`s, by
    their log-sum-exp (flash-decoding's combine), in float32 on
    ``first``."""
    partials = [tuple(t.to(first) for t in pt) for pt in partials]
    mx = partials[0][1]
    for _, m, _ in partials[1:]:
        mx = torch.maximum(mx, m)
    num, den = None, None
    for acc, m, l in partials:
        w = torch.exp(m - mx)
        num = acc * w[..., None] if num is None else num + acc * w[..., None]
        den = l * w if den is None else den + l * w
    return num / den[..., None]


def _attended(cache: Split) -> list:
    """The cache parts a decode step attends: every part of a split cache,
    the first of a replicated one."""
    return list(range(len(cache.parts))) if cache.dim is not None else [0]


def _heads_of(p: Split, x):
    """``_project(x, w)`` for a weight split by heads (gathered on x's
    device) or whole."""
    if p.dim is None:
        return _project(x, p.parts[0])
    return torch.cat([_project(x.to(w.device), w).to(x.device)
                      for w in p.parts], dim=2)


def _out_row(o, wo: Split, first):
    """``_out(o, wo)`` with ``wo`` split by heads (each device's heads,
    summed) or whole."""
    if wo.dim is None:
        return _out(o, wo.parts[0])
    h = o.shape[2] // len(wo.parts)
    return common.sum_partials(
        [_out(o[:, :, m * h:(m + 1) * h].to(w.device), w, f32=True)
         for m, w in enumerate(wo.parts)], first, o.dtype)


def attention_decode_row(cfg: AttnConfig, p: dict, x, cache: dict, pos: int,
                         devices, cross: bool = False):
    """:func:`self_attention_decode` (or, with ``cross``,
    :func:`cross_attention_cached`) over a row, the cache a :class:`Split`
    per entry: by heads, each device runs its heads in place; on the
    sequence (or replicated), the new entries are written where they fall
    and the shards' partial softmaxes combined."""
    msz = len(devices)
    first = x.device
    if cache["k"].dim == 2:
        ys = []
        for m, dev in enumerate(devices):
            cfg_m, p_m = _head_shard(cfg, p, m, msz)
            c_m = {"k": cache["k"].parts[m], "v": cache["v"].parts[m]}
            if cross:
                y, _ = cross_attention_cached(cfg_m, p_m, x.to(dev), c_m,
                                              f32=True)
            else:
                y, _ = self_attention_decode(cfg_m, p_m, x.to(dev), c_m, pos,
                                             f32=True)
            ys.append(y)
        return common.sum_partials(ys, first, x.dtype), cache
    b = x.shape[0]
    q = _heads_of(p["wq"], x)
    valid = None
    if not cross:
        k = _project(x, p["wk"].parts[0])
        v = _project(x, p["wv"].parts[0])
        if cfg.use_rope:
            posb = torch.full((b, 1), pos, device=first)
            q = common.apply_rope(q, posb, cfg.rope_theta)
            k = common.apply_rope(k, posb, cfg.rope_theta)
        cache["k"].write(k.to(cache["k"].parts[0].dtype), 1, pos)
        cache["v"].write(v.to(cache["v"].parts[0].dtype), 1, pos)
    h, dh = q.shape[2], q.shape[3]
    hkv = cfg.n_kv_heads
    scale = 1.0 / math.sqrt(dh)
    partials = []
    for m in _attended(cache["k"]):
        kc, vc = cache["k"].parts[m], cache["v"].parts[m]
        dev = kc.device
        qr = q.reshape(b, hkv, h // hkv, dh).to(dev).float()
        s = (qr @ kc.permute(0, 2, 3, 1).float()) * scale
        if not cross:
            if cfg.softcap is not None:
                s = common.softcap(s, cfg.softcap)
            lo = cache["k"].bounds(m)[0] if cache["k"].dim is not None else 0
            k_pos = lo + torch.arange(kc.shape[1], device=dev)
            valid = k_pos <= pos
            if cfg.window is not None:
                valid = torch.logical_and(valid, k_pos > pos - cfg.window)
            s = torch.where(valid, s, common.NEG_INF)
        partials.append(_partial(s, vc.permute(0, 2, 1, 3)))
    o = _combine(first, partials).reshape(b, 1, h, dh).to(q.dtype)
    return _out_row(o, p["wo"], first), cache


def _mla_shard(p: dict, m: int) -> dict:
    return {n: w.parts[m] for n, w in p.items()}


def mla_attention_row(cfg: MLAConfig, p: dict, x, positions, devices):
    """:func:`mla_attention` over a row: each device's heads when they
    divide the model axis, else its slice of the query sequence against
    the whole latent.  Returns ``(y, (latent, k_rope))``, whole."""
    msz = len(devices)
    first = x.device
    acfg = AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_heads, head_dim=cfg.qk_dim,
                      use_rope=False, chunk_q=cfg.chunk_q,
                      chunk_k=cfg.chunk_k)
    if heads_split(acfg, msz):
        cfg_m = dataclasses.replace(cfg, n_heads=cfg.n_heads // msz)
        ys, kv = [], None
        with hints.paused():
            for m, dev in enumerate(devices):
                p_m = _mla_shard(p, m)
                out, payload = _mla_heads(cfg_m, p_m, x.to(dev),
                                          positions.to(dev))
                ys.append(_out(out, p_m["wo"], f32=True))
                kv = kv or tuple(t.to(first) for t in payload)
        return common.sum_partials(ys, first, x.dtype), kv
    xs = torch.tensor_split(x, msz, dim=1)
    pos = torch.tensor_split(positions, msz, dim=1)
    qs, lats, ropes = [], [], []
    for m, dev in enumerate(devices):
        p_m = _mla_shard(p, m)
        qs.append(_mla_q(cfg, p_m, xs[m].to(dev), pos[m].to(dev)))
        lat, kr = _mla_latent(cfg, p_m, xs[m].to(dev), pos[m].to(dev))
        lats.append(lat.to(first))
        ropes.append(kr.to(first))
    latent, k_rope = torch.cat(lats, dim=1), torch.cat(ropes, dim=1)
    ys, start = [], 0
    for m, dev in enumerate(devices):
        p_m = _mla_shard(p, m)
        lat = latent.to(dev)
        k_nope, v = _project(lat, p_m["wuk"]), _project(lat, p_m["wuv"])
        kr = k_rope.to(dev)
        k_rope_h = kr[:, :, None, :].expand(*kr.shape[:2], cfg.n_heads,
                                           cfg.qk_rope_dim)
        q = torch.cat(qs[m], dim=-1)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        v_p = torch.nn.functional.pad(v, (0, cfg.qk_dim - cfg.v_dim))
        o = chunked_attention(acfg, q, k, v_p, q_start=start)[..., :cfg.v_dim]
        ys.append(_out(o, p_m["wo"]).to(first))
        start += xs[m].shape[1]
    return torch.cat(ys, dim=1), (latent, k_rope)


def mla_attention_decode_row(cfg: MLAConfig, p: dict, x, cache: dict,
                             pos: int, devices):
    """:func:`mla_attention_decode` over a row: the absorbed query of every
    head (each device's heads, gathered), the latent cache's sequence
    shards' partial softmaxes combined, then each device's heads of the
    value and output projections, summed."""
    first = x.device
    b = x.shape[0]
    posb = torch.full((b, 1), pos, device=first)
    p0 = _mla_shard(p, 0)
    split = p["wuq"].dim is not None
    if split:
        q_nope, q_abs, q_rope = [], [], []
        for m, w in enumerate(p["wuq"].parts):
            dev = w.device
            p_m = _mla_shard(p, m)
            qn, qr = _mla_q(cfg, p_m, x.to(dev), posb.to(dev))
            q_abs.append(common.einsum("bhe,rhe->bhr", qn[:, 0],
                                       p_m["wuk"]).to(first))
            q_rope.append(qr[:, 0].to(first))
        q_abs, q_rope = torch.cat(q_abs, dim=1), torch.cat(q_rope, dim=1)
    else:
        qn, qr = _mla_q(cfg, p0, x, posb)
        q_abs = common.einsum("bhe,rhe->bhr", qn[:, 0], p0["wuk"])
        q_rope = qr[:, 0]
    latent_new, k_rope_new = _mla_latent(cfg, p0, x, posb)
    cache["latent"].write(latent_new.to(cache["latent"].parts[0].dtype), 1,
                          pos)
    cache["k_rope"].write(k_rope_new.to(cache["k_rope"].parts[0].dtype), 1,
                          pos)
    partials = []
    for m in _attended(cache["latent"]):
        lat, kr = cache["latent"].parts[m], cache["k_rope"].parts[m]
        dev = lat.device
        s = common.einsum("bhr,bkr->bhk", q_abs.to(dev), lat, f32=True)
        s = s + common.einsum("bhe,bke->bhk", q_rope.to(dev), kr, f32=True)
        s = s / math.sqrt(cfg.qk_dim)
        lo = (cache["latent"].bounds(m)[0]
              if cache["latent"].dim is not None else 0)
        k_posn = lo + torch.arange(lat.shape[1], device=dev)
        s = torch.where((k_posn <= pos)[None, None], s, common.NEG_INF)
        partials.append(_partial(s, lat))
    o_lat = _combine(first, partials).to(x.dtype)
    if not split:
        out = common.einsum("bhr,rhe->bhe", o_lat, p0["wuv"])
        return common.einsum("bhe,hed->bd", out, p0["wo"])[:, None], cache
    h = cfg.n_heads // len(p["wuv"].parts)
    ys = []
    for m, w in enumerate(p["wuv"].parts):
        o_m = o_lat[:, m * h:(m + 1) * h].to(w.device)
        out = common.einsum("bhr,rhe->bhe", o_m, w)
        ys.append(common.partial_einsum("bhe,hed->bd", out, p["wo"].parts[m]))
    return common.sum_partials(ys, first, x.dtype)[:, None], cache
