"""State-space / gated-linear-attention mixers: shared chunked core + Mamba2.

The twin of ``repro.models.ssm``.  The core computes, per head, the gated
linear-attention recurrence

    S_t = exp(log_decay_t) * S_{t-1} + exp(gate_t) * v_t k_t^T
    n_t = exp(log_decay_t) * n_{t-1} + exp(gate_t) * k_t          (optional)
    y_t = q_t @ S_t   [ / max(|q_t . n_t|, 1) ]

in *chunked* form: quadratic (matmul-rich) within chunks of length ``Lc``,
and across chunks the prefix of the chunk summaries.  ``repro`` takes that
prefix with a log-depth ``associative_scan``; the port takes it as one
product with the lower-triangular matrix of cumulative chunk decays
(``exp`` of the chunk log-decays summed over ``(j, c]``), so no Python
loop runs over the chunks.
The two orders of rounding differ; ``tests/test_torch_ssm.py`` holds them
together.

Products are float32 whatever the inputs' dtype (``repro``'s
``preferred_element_type=float32``: ``common.einsum(..., f32=True)``),
and the port casts where ``repro``
casts: the within-chunk weights, the chunk-end weights, the cumulative
decays and the carried state go to the input dtype before the product that
reads them, and the output is in ``v``'s dtype.  The one difference: the
within-chunk weights ``exp(L_t - L_t' + g_t')`` are masked *before* the
exponential (``exp(-inf) = 0``), where ``repro`` masks after it.  The
forward values are the same; ``repro``'s gradient is ``0 * exp(large)``, a
NaN, wherever a masked exponent overflows float32, and the port's is 0.

Mamba2 (SSD) maps onto the core with q=C, k=B, v=dt*x, log_decay=dt*A and no
normalizer; mLSTM (``models.xlstm``) adds sigmoid-forget decays, clamped
exponential input gates and the normalizer state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.attention import TensorSpec
from repro_torch.models.params import ParamDecl, ParamTable

# ---------------------------------------------------------------------------
# Shared chunked core
# ---------------------------------------------------------------------------


def chunked_gla(
    q: torch.Tensor,  # (B, S, H, Dk)
    k: torch.Tensor,  # (B, S, H, Dk)
    v: torch.Tensor,  # (B, S, H, Dv)
    log_decay: torch.Tensor,  # (B, S, H), <= 0
    gate: torch.Tensor,  # (B, S, H), log input weights
    chunk: int = 128,
    normalize: bool = False,
    state: tuple | None = None,  # (S0 (B,H,Dk,Dv), n0 (B,H,Dk))
):
    """Returns (y (B,S,H,Dv), (S_final, n_final)); the state is float32."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    dev = q.device
    lc = min(chunk, s)
    while s % lc:
        lc //= 2
    nc = s // lc

    def cshape(x):
        return x.reshape(b, nc, lc, *x.shape[2:])

    qc, kc, vc = cshape(q), cshape(k), cshape(v)
    ldc, gc = cshape(log_decay), cshape(gate)
    lcum = torch.cumsum(ldc.float(), dim=2)  # (B,nc,Lc,H) inclusive
    l_last = lcum[:, :, -1]  # (B,nc,H)

    # ---- within-chunk quadratic part -------------------------------------
    # W[t, t'] = exp(L_t - L_{t'} + g_{t'}) for t' <= t
    wexp = lcum[:, :, :, None, :] - lcum[:, :, None, :, :] + gc[:, :, None, :, :]
    t_idx = torch.arange(lc, device=dev)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, None, :, :, None]
    w = torch.exp(torch.where(causal, wexp, float("-inf")))  # (B,nc,Lc,Lc',H)
    sqk = common.einsum("bclhd,bcmhd->bclmh", qc, kc, f32=True)
    ws = w * sqk
    y_intra = common.einsum("bclmh,bcmhv->bclhv", ws.to(v.dtype), vc,
                            f32=True)
    if normalize:
        n_intra = common.einsum("bclmh,bcmhd->bclhd", w.to(k.dtype), kc,
                                f32=True)

    # ---- chunk summaries ---------------------------------------------------
    w_end = torch.exp(l_last[:, :, None] - lcum + gc)  # (B,nc,Lc,H)
    s_chunk = common.einsum("bclh,bclhd,bclhv->bchdv", w_end.to(k.dtype), kc,
                            vc, f32=True)
    n_chunk = common.einsum("bclh,bclhd->bchd", w_end.to(k.dtype), kc,
                            f32=True)

    # ---- inter-chunk prefix: one product with the cumulative decays -------
    # decay[c, j] = prod_{j < m <= c} exp(l_last[m]) for j <= c, its
    # exponent summed over (j, c] alone (a difference of two cumulative sums
    # would lose their magnitude's rounding).
    c_idx = torch.arange(nc, device=dev)
    after = (c_idx[:, None] > c_idx[None, :])[None, :, :, None]
    lower = (c_idx[:, None] >= c_idx[None, :])[None, :, :, None]
    segsum = torch.cumsum(torch.where(after, l_last[:, :, None, :], 0.0),
                          dim=1)  # (B, c, j, H)
    decay = torch.exp(torch.where(lower, segsum, float("-inf")))
    s_i = torch.einsum("bcjh,bjhdv->bchdv", decay, s_chunk)
    n_i = torch.einsum("bcjh,bjhd->bchd", decay, n_chunk)
    dec_i = torch.exp(torch.cumsum(l_last, dim=1))  # (B,nc,H)
    if state is None:
        s0 = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
        n0 = torch.zeros((b, h, dk), dtype=torch.float32, device=dev)
    else:
        s0, n0 = state
        s0 = s0.float()
        n0 = n0.float()
    # exclusive prefix: state seen by chunk c = dec_i[c-1]*s0 + s_i[c-1]
    dec_prev = torch.cat([torch.ones((b, 1, h), dtype=torch.float32,
                                     device=dev), dec_i[:, :-1]], dim=1)
    s_prev = torch.cat([torch.zeros_like(s_i[:, :1]), s_i[:, :-1]], dim=1)
    s_prev = s_prev + dec_prev[..., None, None] * s0[:, None]
    n_prev = torch.cat([torch.zeros_like(n_i[:, :1]), n_i[:, :-1]], dim=1)
    n_prev = n_prev + dec_prev[..., None] * n0[:, None]

    # ---- inter-chunk contribution ------------------------------------------
    elc = torch.exp(lcum)  # (B,nc,Lc,H)
    y_inter = common.einsum("bclh,bclhd,bchdv->bclhv", elc.to(q.dtype), qc,
                            s_prev.to(q.dtype), f32=True)
    y = (y_intra + y_inter).float()

    if normalize:
        n_t = n_intra + elc[..., None] * n_prev[:, :, None].float()
        denom = torch.abs(torch.einsum("bclhd,bclhd->bclh", qc.float(), n_t))
        y = y / torch.clamp(denom, min=1.0)[..., None]

    s_fin = dec_i[:, -1][..., None, None] * s0 + s_i[:, -1]
    n_fin = dec_i[:, -1][..., None] * n0 + n_i[:, -1]
    return y.reshape(b, s, h, dv).to(v.dtype), (s_fin, n_fin)


def gla_decode_step(q, k, v, log_decay, gate, state, normalize: bool = False):
    """One-token recurrent update. q/k/v: (B,H,D*); state (S, n)."""
    s_st, n_st = state
    d = torch.exp(log_decay.float())  # (B,H)
    g = torch.exp(gate.float())
    s_new = d[..., None, None] * s_st + g[..., None, None] * common.einsum(
        "bhd,bhv->bhdv", k, v).float()
    n_new = d[..., None] * n_st + g[..., None] * k.float()
    y = common.einsum("bhd,bhdv->bhv", q.float(), s_new)
    if normalize:
        denom = torch.abs(common.einsum("bhd,bhd->bh", q.float(), n_new))
        y = y / torch.clamp(denom, min=1.0)[..., None]
    return y.to(v.dtype), (s_new, n_new)


# ---------------------------------------------------------------------------
# Causal depthwise conv (width 4), static shifts
# ---------------------------------------------------------------------------


def causal_conv4(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, 4); returns silu(conv(x))."""
    acc = x * w[None, None, :, 3]
    for i in range(1, 4):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        acc = acc + shifted * w[None, None, :, 3 - i]
    return F.silu(acc + b[None, None])


def causal_conv4_step(x_t: torch.Tensor, conv_state: torch.Tensor, w, b):
    """x_t: (B, C); conv_state: (B, 3, C) last 3 inputs. Returns (y, state)."""
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None].to(dt)], dim=1)
    y = common.einsum("bkc,ck->bc", window, w) + b[None]
    return F.silu(y), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_param_table(cfg: Mamba2Config) -> ParamTable:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    return {
        "w_z": ParamDecl((d, di), ("embed", "inner")),
        "w_x": ParamDecl((d, di), ("embed", "inner")),
        "w_b": ParamDecl((d, n), ("embed", "state")),
        "w_c": ParamDecl((d, n), ("embed", "state")),
        "w_dt": ParamDecl((d, h), ("embed", "heads")),
        "dt_bias": ParamDecl((h,), ("heads",), init="zeros"),
        "a_log": ParamDecl((h,), ("heads",), init="zeros"),
        "d_skip": ParamDecl((h,), ("heads",), init="ones"),
        "conv_x_w": ParamDecl((di, 4), ("inner", None)),
        "conv_x_b": ParamDecl((di,), ("inner",), init="zeros"),
        "conv_b_w": ParamDecl((n, 4), ("state", None)),
        "conv_b_b": ParamDecl((n,), ("state",), init="zeros"),
        "conv_c_w": ParamDecl((n, 4), ("state", None)),
        "conv_c_b": ParamDecl((n,), ("state",), init="zeros"),
        "norm": ParamDecl((di,), ("inner",), init="zeros"),
        "w_out": ParamDecl((di, d), ("inner", "embed"), init="output"),
    }


def _mamba2_inputs(cfg: Mamba2Config, p: dict, x: torch.Tensor):
    z = common.matmul(x, p["w_z"])
    xi = common.matmul(x, p["w_x"])
    bb = common.matmul(x, p["w_b"])
    cc = common.matmul(x, p["w_c"])
    dt = F.softplus(common.matmul(x, p["w_dt"]).float()
                    + p["dt_bias"].float())
    return z, xi, bb, cc, dt


def mamba2(cfg: Mamba2Config, p: dict, x: torch.Tensor):
    """Training/prefill. Returns (y, decode-ready cache payload)."""
    b, s, _ = x.shape
    h, pd, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    z, xi, bb, cc, dt = _mamba2_inputs(cfg, p, x)
    xi_raw, bb_raw, cc_raw = xi, bb, cc  # pre-conv inputs (decode conv windows)
    xi = causal_conv4(xi, p["conv_x_w"], p["conv_x_b"])
    bb = causal_conv4(bb, p["conv_b_w"], p["conv_b_b"])
    cc = causal_conv4(cc, p["conv_c_w"], p["conv_c_b"])
    xh = xi.reshape(b, s, h, pd)
    a = -torch.exp(p["a_log"].float())  # (h,) < 0
    log_decay = dt * a[None, None, :]  # (B,S,H) <= 0
    qh = cc[:, :, None].expand(b, s, h, n).to(x.dtype)
    kh = bb[:, :, None].expand(b, s, h, n).to(x.dtype)
    vh = (xh * dt[..., None]).to(x.dtype)
    y, (s_fin, _) = chunked_gla(qh, kh, vh, log_decay,
                                torch.zeros_like(log_decay), chunk=cfg.chunk)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = common.rms_norm(y * F.silu(z), p["norm"])
    cache = {"ssm": s_fin, "conv_x": xi_raw[:, -3:], "conv_b": bb_raw[:, -3:],
             "conv_c": cc_raw[:, -3:]}
    return common.matmul(y, p["w_out"]), cache


def mamba2_decode(cfg: Mamba2Config, p: dict, x: torch.Tensor, cache: dict):
    """x: (B, 1, d). cache: {"ssm": (B,H,N,P), "conv_x": (B,3,di), ...}.
    Returns (out, the new cache tensors)."""
    b = x.shape[0]
    h, pd, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    z, xi, bb, cc, dt = _mamba2_inputs(cfg, p, x)
    xi1, conv_x = causal_conv4_step(xi[:, 0], cache["conv_x"], p["conv_x_w"],
                                    p["conv_x_b"])
    bb1, conv_b = causal_conv4_step(bb[:, 0], cache["conv_b"], p["conv_b_w"],
                                    p["conv_b_b"])
    cc1, conv_c = causal_conv4_step(cc[:, 0], cache["conv_c"], p["conv_c_w"],
                                    p["conv_c_b"])
    xh = xi1.reshape(b, h, pd)
    a = -torch.exp(p["a_log"].float())
    dt1 = dt[:, 0]  # (B,H)
    qh = cc1[:, None].expand(b, h, n).to(x.dtype)
    kh = bb1[:, None].expand(b, h, n).to(x.dtype)
    vh = (xh * dt1[..., None]).to(x.dtype)
    y, (s_new, _) = gla_decode_step(
        qh, kh, vh, dt1 * a[None], torch.zeros_like(dt1),
        (cache["ssm"], torch.zeros((b, h, n), dtype=torch.float32,
                                   device=x.device)),
    )
    y = y + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, cfg.d_inner)
    y = common.rms_norm(y * F.silu(z), p["norm"])
    out = common.matmul(y, p["w_out"])
    return out, {"ssm": s_new, "conv_x": conv_x, "conv_b": conv_b,
                 "conv_c": conv_c}


def mamba2_cache_spec(cfg: Mamba2Config, batch: int, dtype):
    h, pd, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    return {
        "ssm": TensorSpec((batch, h, n, pd), torch.float32),
        "conv_x": TensorSpec((batch, 3, cfg.d_inner), dtype),
        "conv_b": TensorSpec((batch, 3, n), dtype),
        "conv_c": TensorSpec((batch, 3, n), dtype),
    }
