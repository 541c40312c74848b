"""xLSTM blocks: mLSTM (matrix memory, chunked) and sLSTM (scalar memory).

The twin of ``repro.models.xlstm``.  mLSTM rides the shared ``chunked_gla``
core (``models.ssm``): sigmoid forget gates give log-decays <= 0, input
gates are exponential with a softcap clamp (boundedness replaces the
running-max stabilizer), and the normalizer state ``n`` implements
``h = C q / max(|n . q|, 1)``.

sLSTM has true recurrence (gates read h_{t-1} through block-diagonal R).
``repro`` runs it as a ``lax.scan`` over time and differentiates it with
``jax.grad``; the port runs it as a loop of steps over static buffers (a
device counter picks each step's row), eager on the CPU and on the card
one replay of a CUDA graph a step for long sequences, and gives the loop
its own backward (:class:`_Scan`: the cell's local derivatives for all
steps at once, then the carry's gradients as a reverse loop of steps).
The carry ``(h, c, n, m)`` stays float32, the stabilizer ``m`` starting
at -1e30, and each step's output ``h`` is cast to the input's dtype.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.attention import TensorSpec
from repro_torch.models.params import ParamDecl, ParamTable
from repro_torch.models.ssm import (
    causal_conv4,
    causal_conv4_step,
    chunked_gla,
    gla_decode_step,
)

GATE_CLAMP = 15.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int
    expand: int = 2
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def mlstm_param_table(cfg: MLSTMConfig) -> ParamTable:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "w_up": ParamDecl((d, di), ("embed", "inner")),
        "w_z": ParamDecl((d, di), ("embed", "inner")),
        "conv_w": ParamDecl((di, 4), ("inner", None)),
        "conv_b": ParamDecl((di,), ("inner",), init="zeros"),
        "w_q": ParamDecl((di, di), ("inner", "inner2")),
        "w_k": ParamDecl((di, di), ("inner", "inner2")),
        "w_v": ParamDecl((di, di), ("inner", "inner2")),
        "w_i": ParamDecl((di, h), ("inner", "heads")),
        "w_f": ParamDecl((di, h), ("inner", "heads")),
        "b_i": ParamDecl((h,), ("heads",), init="zeros"),
        "b_f": ParamDecl((h,), ("heads",), init="ones"),
        "norm": ParamDecl((di,), ("inner",), init="zeros"),
        "w_down": ParamDecl((di, d), ("inner", "embed"), init="output"),
    }


def _key_scale(dh: int, dtype: torch.dtype) -> torch.Tensor:
    """``sqrt(dh)`` in float32, then in ``dtype`` (``repro``'s rounding)."""
    return torch.sqrt(torch.tensor(float(dh), dtype=torch.float32)).to(dtype)


def _mlstm_qkv_gates(cfg: MLSTMConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    mm = common.matmul
    up = mm(x, p["w_up"])
    z = mm(x, p["w_z"])
    c = causal_conv4(up, p["conv_w"], p["conv_b"])
    q = mm(c, p["w_q"]).reshape(b, s, h, dh)
    k = mm(c, p["w_k"]).reshape(b, s, h, dh)
    v = mm(up, p["w_v"]).reshape(b, s, h, dh)
    i_raw = mm(up, p["w_i"]) + p["b_i"]
    f_raw = mm(up, p["w_f"]) + p["b_f"]
    log_f = F.logsigmoid(f_raw.float())
    log_i = common.softcap(i_raw.float(), GATE_CLAMP)
    k = k / _key_scale(dh, k.dtype).to(k.device)
    return q, k, v, log_f, log_i, z, up


def mlstm(cfg: MLSTMConfig, p: dict, x: torch.Tensor):
    b, s, _ = x.shape
    q, k, v, log_f, log_i, z, up = _mlstm_qkv_gates(cfg, p, x)
    y, state = chunked_gla(q, k, v, log_f, log_i, chunk=cfg.chunk,
                           normalize=True)
    y = y.reshape(b, s, cfg.d_inner)
    y = common.rms_norm(y, p["norm"]) * F.silu(z)
    cache = {"s": state[0], "n": state[1], "conv": up[:, -3:]}
    return common.matmul(y, p["w_down"]), cache


def mlstm_decode(cfg: MLSTMConfig, p: dict, x: torch.Tensor, cache: dict):
    """Returns (out, the new cache tensors)."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    mm = common.matmul
    up = mm(x, p["w_up"])[:, 0]
    z = mm(x, p["w_z"])[:, 0]
    c, conv_state = causal_conv4_step(up, cache["conv"], p["conv_w"],
                                      p["conv_b"])
    q = mm(c, p["w_q"]).reshape(b, h, dh)
    k = mm(c, p["w_k"]).reshape(b, h, dh) / _key_scale(dh, x.dtype).to(
        x.device)
    v = mm(up, p["w_v"]).reshape(b, h, dh)
    log_f = F.logsigmoid((mm(up, p["w_f"]) + p["b_f"]).float())
    log_i = common.softcap((mm(up, p["w_i"]) + p["b_i"]).float(), GATE_CLAMP)
    y, state = gla_decode_step(q, k, v, log_f, log_i,
                               (cache["s"], cache["n"]), normalize=True)
    y = y.reshape(b, 1, cfg.d_inner)
    y = common.rms_norm(y, p["norm"]) * F.silu(z)[:, None]
    out = common.matmul(y, p["w_down"])
    return out, {"s": state[0], "n": state[1], "conv": conv_state}


def mlstm_cache_spec(cfg: MLSTMConfig, batch: int, dtype):
    h, dh = cfg.n_heads, cfg.head_dim
    return {
        "s": TensorSpec((batch, h, dh, dh), torch.float32),
        "n": TensorSpec((batch, h, dh), torch.float32),
        "conv": TensorSpec((batch, 3, cfg.d_inner), dtype),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int
    ff_factor: float = 4.0 / 3.0


def slstm_param_table(cfg: SLSTMConfig) -> ParamTable:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dff = int(cfg.ff_factor * d)
    return {
        "norm": ParamDecl((d,), ("embed",), init="zeros"),
        "w_gates": ParamDecl((d, 4 * d), ("embed", "inner")),  # i,f,z,o
        "r_gates": ParamDecl((h, dh, 4 * dh), ("heads", None, None)),  # blockdiag
        "b_gates": ParamDecl((4 * d,), ("inner",), init="zeros"),
        "gnorm": ParamDecl((d,), ("embed",), init="zeros"),
        "ffn/w_gate": ParamDecl((d, dff), ("embed", "mlp")),
        "ffn/w_up": ParamDecl((d, dff), ("embed", "mlp")),
        "ffn/w_down": ParamDecl((dff, d), ("mlp", "embed"), init="output"),
        "ffn_norm": ParamDecl((d,), ("embed",), init="zeros"),
    }


def _cell(gates, c_prev, n_prev, m_prev):
    """The cell's elementwise part: float32 ``gates`` (.., 4d), i|f|z|o,
    and the float32 carry -> ``(h, c, n, m)``."""
    i_raw, f_raw, z_raw, o_raw = torch.chunk(gates, 4, dim=-1)
    a = F.logsigmoid(f_raw) + m_prev
    m_new = torch.maximum(a, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(a - m_new)
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    c_new = f_g * c_prev + i_g * z
    n_new = f_g * n_prev + i_g
    h_new = o * (c_new / torch.clamp(n_new, min=1.0))
    return h_new, c_new, n_new, m_new


def _gates(cfg: SLSTMConfig, wx_t, h_prev, r, b):
    """``wx_t + h_prev R + b`` in float32 (``repro``'s order): ``R`` block
    diagonal, one ``(dh, 4 dh)`` block a head."""
    nh = cfg.n_heads
    hh = h_prev.reshape(h_prev.shape[0], nh, cfg.d_model // nh)
    rx = common.einsum("bhd,hde->bhe", hh, r).reshape(h_prev.shape[0], -1)
    return (wx_t + rx + b).float()


#: Sequences at least this long run each step of the loop as one replay of
#: a CUDA graph on the card.
GRAPH_MIN_STEPS = 64


def _run_steps(step, steps: int, device) -> None:
    """``step()`` ``steps`` times.  On the card, for long loops, the first
    call runs eagerly (the warm-up capture needs) and the rest replay one
    CUDA graph of it: ``step`` reads and advances a device counter and
    works on static buffers, so every replay is the next step.  On
    ``"meta"`` tensors (the dry run) there are no values, so one step gives
    every shape; the dry run adds the other steps' FLOPs analytically
    (``roofline.slstm_extra_flops``), as it must for the card's replays,
    which dispatch no operator it could count."""
    if device.type == "meta":
        step()
        return
    if device.type != "cuda" or steps < GRAPH_MIN_STEPS:
        for _ in range(steps):
            step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    for _ in range(steps - 1):
        graph.replay()


def _forward_loop(cfg, wx, r, b, carry, save: bool):
    """The loop over time.  ``wx`` (S, B, 4d); the carry's tensors are
    updated in place.  Returns ``hs`` (S, B, d) in ``wx``'s dtype and, with
    ``save``, each step's float32 gates and incoming carry (S, B, .)."""
    s, bsz, _ = wx.shape
    h, c, n, m = carry
    hs = torch.empty((s, bsz, cfg.d_model), dtype=wx.dtype, device=wx.device)
    saved = ([torch.empty(wx.shape, dtype=torch.float32, device=wx.device)]
             + [torch.empty((s, *h.shape), dtype=torch.float32,
                            device=wx.device) for _ in range(4)]
             if save else [])
    t = torch.zeros(1, dtype=torch.long, device=wx.device)

    def step():
        gates = _gates(cfg, wx.index_select(0, t)[0], h, r, b)
        if save:
            for buf, v in zip(saved, (gates, h, c, n, m)):
                buf.index_copy_(0, t, v[None])
        out = _cell(gates, c, n, m)
        hs.index_copy_(0, t, out[0].to(hs.dtype)[None])
        for buf, v in zip((h, c, n, m), out):
            buf.copy_(v)
        t.add_(1)

    _run_steps(step, s, wx.device)
    return hs, saved


def _tie(x, y):
    """``jnp.maximum(x, y)``'s derivative in ``x``: 1, 1/2 at a tie, 0."""
    return (x > y).float() + 0.5 * (x == y).float()


class _Scan(torch.autograd.Function):
    """The sLSTM's loop over time with its own backward: the forward loop
    saves each step's gates and incoming carry, the backward takes the
    cell's local derivatives for all steps at once and runs the
    recurrence of the carry's gradients as a loop of steps (a CUDA graph
    replay each on the card).  Gradients follow ``repro``'s ``jax.grad``
    (``jnp.maximum`` splits a tie)."""

    @staticmethod
    def forward(ctx, wx, r, b, h0, c0, n0, m0, cfg):
        carry = tuple(x.detach().clone() for x in (h0, c0, n0, m0))
        hs, saved = _forward_loop(cfg, wx, r, b, carry, save=True)
        ctx.save_for_backward(r, *saved)
        ctx.cfg, ctx.dtypes = cfg, (wx.dtype, b.dtype)
        return (hs, *carry)

    @staticmethod
    def backward(ctx, d_hs, dh_t, dc_t, dn_t, dm_t):
        r, gates, h_prev, c_prev, n_prev, m_prev = ctx.saved_tensors
        cfg = ctx.cfg
        nh = cfg.n_heads
        dh = cfg.d_model // nh
        s, bsz, _ = gates.shape
        # The cell's local derivatives, every step at once.
        i_raw, f_raw, z_raw, o_raw = torch.chunk(gates, 4, dim=-1)
        a = F.logsigmoid(f_raw) + m_prev
        m_new = torch.maximum(a, i_raw)
        i_g = torch.exp(i_raw - m_new)
        f_g = torch.exp(a - m_new)
        z = torch.tanh(z_raw)
        o = torch.sigmoid(o_raw)
        c_new = f_g * c_prev + i_g * z
        n_new = f_g * n_prev + i_g
        nc = torch.clamp(n_new, min=1.0)
        ga = _tie(a, i_raw)
        names = ("o", "c", "n", "c_prev", "n_prev", "z", "z_raw", "i_g",
                 "f_g", "ga", "gi", "f_raw", "out")
        # One (S, 13, B, d) stack: a step reads its row with one gather.
        coef = torch.stack([
            c_new / nc * o * (1 - o), o / nc,
            -o * c_new / (nc * nc) * _tie(n_new, torch.ones_like(n_new)),
            c_prev, n_prev, z, i_g * (1 - z * z), i_g, f_g, ga, 1 - ga,
            torch.sigmoid(-f_raw), d_hs.float()], dim=1)
        del a, m_new, z, o, c_new, n_new, nc, ga
        r32 = r.float()
        grads = [torch.zeros_like(h_prev[0]) if g is None else g.float().clone()
                 for g in (dh_t, dc_t, dn_t, dm_t)]
        g_h, g_c, g_n, g_m = grads
        d_gates = torch.empty_like(gates)
        t = torch.full((1,), s - 1, dtype=torch.long, device=gates.device)

        def step():
            k = dict(zip(names, coef.index_select(0, t)[0].unbind(0)))
            dh_ = g_h + k["out"]
            dc = g_c + dh_ * k["c"]
            dn = g_n + dh_ * k["n"]
            df_g = dc * k["c_prev"] + dn * k["n_prev"]
            di_g = dc * k["z"] + dn
            t1, t2 = di_g * k["i_g"], df_g * k["f_g"]
            dm = g_m - t1 - t2
            da = t2 + dm * k["ga"]
            dg = torch.cat([t1 + dm * k["gi"], da * k["f_raw"],
                            dc * k["z_raw"], dh_ * k["o"]], dim=-1)
            d_gates.index_copy_(0, t, dg[None])
            g_h.copy_(torch.einsum("bhe,hde->bhd", dg.view(bsz, nh, 4 * dh),
                                   r32).reshape(bsz, -1))
            g_c.copy_(dc * k["f_g"])
            g_n.copy_(dn * k["f_g"])
            g_m.copy_(da)
            t.sub_(1)

        _run_steps(step, s, gates.device)
        wx_dtype, b_dtype = ctx.dtypes
        d_r = torch.einsum("sbhd,sbhe->hde", h_prev.view(s, bsz, nh, dh),
                           d_gates.view(s, bsz, nh, 4 * dh)).to(r.dtype)
        d_b = d_gates.sum(dim=(0, 1)).to(b_dtype)
        return (d_gates.to(wx_dtype), d_r, d_b, g_h, g_c, g_n, g_m, None)


def _slstm_scan(cfg: SLSTMConfig, wx, r, b, carry):
    """``wx`` (B, S, 4d) through the loop: ``(hs (B, S, d), carry)``."""
    wx = wx.transpose(0, 1).contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (wx, r, b, *carry)):
        hs, *carry = _Scan.apply(wx, r, b, *carry, cfg)
    else:
        carry = tuple(x.clone() for x in carry)
        hs, _ = _forward_loop(cfg, wx, r, b, carry, save=False)
    return hs.transpose(0, 1), tuple(carry)


def slstm(cfg: SLSTMConfig, p: dict, x: torch.Tensor, carry=None):
    """x: (B, S, d). The sequential loop over time (module docstring)."""
    b, s, d = x.shape
    xn = common.rms_norm(x, p["norm"])
    wx = common.matmul(xn, p["w_gates"])  # (B,S,4d)
    if carry is None:
        carry = slstm_init_carry(cfg, b, x.device)
    y, carry = _slstm_scan(cfg, wx, p["r_gates"], p["b_gates"], carry)
    y = x + common.rms_norm(y, p["gnorm"])
    # post-FFN (xLSTM block structure)
    yn = common.rms_norm(y, p["ffn_norm"])
    ff = common.swiglu(common.matmul(yn, p["ffn/w_gate"]),
                       common.matmul(yn, p["ffn/w_up"]))
    y = y + common.matmul(ff, p["ffn/w_down"])
    return y, carry


def slstm_init_carry(cfg: SLSTMConfig, batch: int, device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros((batch, d), **f32),
        torch.zeros((batch, d), **f32),
        torch.zeros((batch, d), **f32),
        torch.full((batch, d), -1e30, **f32),
    )


def slstm_decode(cfg: SLSTMConfig, p: dict, x: torch.Tensor, cache: dict):
    """Returns (y, the new cache tensors)."""
    y, carry = slstm(cfg, p, x, carry=tuple(cache["carry"]))
    return y, {"carry": list(carry)}


def slstm_cache_spec(cfg: SLSTMConfig, batch: int, dtype):
    d = cfg.d_model
    return {"carry": [TensorSpec((batch, d), torch.float32)
                      for _ in range(4)]}
