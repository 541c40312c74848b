"""State-space and xLSTM modules and their two models against repro's, on the CPU.

``models/ssm.py`` (``chunked_gla``, ``gla_decode_step``, the width-4
convolutions, Mamba2) and ``models/xlstm.py`` (mLSTM, sLSTM) held against
``repro``'s twins on the same numpy-seeded inputs in float32 and float64,
the twins of ``tests/test_mixers.py``'s chunked-against-sequential and
decode-tail checks, and the whole reduced zamba2-2.7b (Mamba2 with one
shared attention block) and xlstm-125m against ``repro``: the loss,
prefill's last logits and every cache tensor, two decode steps, and one
train step's loss and gradients, in float32 and bfloat16.  ``repro``'s
programs are compiled once per config and dtype (:func:`reference`,
shared with ``tests/test_torch_moe_mla.py``).

Tolerances (each stated where used):

- modules in float32: 1e-5 (absolute on O(1) values, relative elsewhere),
  ``tests/test_torch_lm.py``'s; the port's inter-chunk prefix is one
  product with cumulative decays where ``repro``'s is an
  ``associative_scan``, measured at most 2.2e-6 apart here;
- modules in float64: 1e-5 too.  ``repro`` computes its products with
  ``preferred_element_type=float32`` (float32 results even from float64
  operands) and so does the port, so both are float32-accurate: measured
  at most 3.1e-7 apart;
- chunked against sequential 2e-4 and decode against the chunked tail
  1e-4 (``tests/test_mixers.py``'s);
- the whole models: ``tests/test_torch_lm.py``'s model tolerances (float32
  3e-4 of max |x|, bfloat16 6e-2 or 1.25 times repro's distance from the
  port's float64 run); gradients the same, per leaf against its max |g|
  (``tests/test_torch_train.py``'s 3e-4 in float32).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (  # noqa: F401  (_float32_jax: autouse fixture)
    DTYPES,
    SHARP_X,
    SMAX,
    S,
    _float32_jax,
    assert_loss_close,
    assert_model_close,
    assert_tree_close,
    f64,
    make_pair,
)

from repro.models import ssm as r_ssm
from repro.models import xlstm as r_xlstm
from repro.train.steps import cast_tree as r_cast_tree
from repro_torch.interop import _tensor
from repro_torch.models import ssm, xlstm
from repro_torch.train.microbatch import accumulated_grads
from repro_torch.train.steps import cast_tree

MODULE_TOL = 1e-5
#: Reduced zamba2's bfloat16 run is far from float64 in both packages
#: (logits 0.06-0.57 of max |logit|, seeds 0-2), and two runs each that
#: far from the truth may lie twice as far apart: there both of
#: tests/test_torch_lm.py's bfloat16 bounds (6e-2 of max |x|, SHARP_X
#: times repro's distance from float64) are doubled.  Measured: up to
#: 1.64 times the single bound (``python tests/test_torch_ssm.py``).
BF16_X = {"zamba2-2.7b": 2.0}
#: Gradients: float32 per leaf against its max |g|
#: (``tests/test_torch_train.py``'s); bfloat16 as one vector, relative L2,
#: within BF16_GRAD_TOL or BF16_GRAD_X times repro's own distance from
#: float64 (two runs each that far from the truth may lie twice as far
#: apart; measured up to 1.43 for zamba2, seeds 0-2).
GRAD_TOL, BF16_GRAD_TOL, BF16_GRAD_X = 3e-4, 6e-2, 2.0
#: Decode steps after prefill in the whole-model checks.
STEPS = 2
ARCHS = ("zamba2-2.7b", "xlstm-125m")
#: XLA's CPU backend without its optimization passes, for repro's float32
#: programs: compiled in ~60% of the time, which is most of these tests'
#: cost.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests on one thread: their tensors are
    tiny, and parallel test workers would otherwise each start one thread
    a core."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture()
def jax_dtype(request):
    """float32, or float64 with JAX's 64-bit mode on for this test only."""
    name = request.param
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", name == "float64")
    yield name
    jax.config.update("jax_enable_x64", was)


BOTH = pytest.mark.parametrize("jax_dtype", ["float32", "float64"],
                               indirect=True)


def _np(rng, *shape, scale=1.0, dtype="float32"):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, tol=MODULE_TOL, what=""):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _tree_close(got, ref, tol=MODULE_TOL, what=""):
    g, r = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert len(g) == len(r), what
    for i, (a, b) in enumerate(zip(g, r)):
        assert tuple(a.shape) == tuple(np.shape(b)), (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


def _params(rng, table, dtype, scale=0.2):
    """Seeded weights for a table: the normal ones drawn, the constant ones
    at their init plus a small draw (so biases and gates are not 0)."""
    out = {}
    for k, d in table.items():
        base = 1.0 if d.init == "ones" else 0.0
        out[k] = (base + _np(rng, *d.shape, scale=scale)).astype(dtype)
    return out


def _tables_equal(ours, ref):
    assert {k: dataclasses.astuple(v) for k, v in ours.items()} == {
        k: (v.shape, v.axes, v.init, v.fan_in) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# The chunked GLA core
# ---------------------------------------------------------------------------


def _gla_inputs(rng, b=2, s=16, h=3, dk=4, dv=5, dtype="float32"):
    return (_np(rng, b, s, h, dk, dtype=dtype),
            _np(rng, b, s, h, dk, dtype=dtype),
            _np(rng, b, s, h, dv, dtype=dtype),
            -np.abs(_np(rng, b, s, h, dtype=dtype)),
            _np(rng, b, s, h, scale=0.3, dtype=dtype))


#: One compiled program a shape (JAX's eager dispatch compiles every op of
#: the associative scan anew for each shape, ~9 s a case).
_r_chunked_gla = jax.jit(r_ssm.chunked_gla,
                         static_argnames=("chunk", "normalize"),
                         compiler_options=FAST_COMPILE)


@BOTH
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("s, chunk", [(16, 2), (16, 4), (16, 16), (15, 4),
                                      (13, 8)])
def test_chunked_gla_matches_repro(jax_dtype, s, chunk, normalize):
    """Chunk sizes 2-16, and odd lengths: 15 under a chunk of 4 and the
    prime 13 under 8 fall to chunks of one (the chunk halves until it
    divides the length)."""
    rng = np.random.default_rng(s * 100 + chunk)
    ins = _gla_inputs(rng, s=s, dtype=jax_dtype)
    y, (s_fin, n_fin) = ssm.chunked_gla(*map(_t, ins), chunk=chunk,
                                        normalize=normalize)
    ry, (rs, rn) = _r_chunked_gla(*ins, chunk=chunk, normalize=normalize)
    assert y.dtype == _t(ins[2]).dtype and s_fin.dtype == torch.float32
    _close(y, ry, what="y")
    _close(s_fin, rs, what="S")
    _close(n_fin, rn, what="n")


@BOTH
def test_chunked_gla_from_a_state_matches_repro(jax_dtype):
    rng = np.random.default_rng(5)
    ins = _gla_inputs(rng, dtype=jax_dtype)
    st = (_np(rng, 2, 3, 4, 5), _np(rng, 2, 3, 4))
    y, (s_fin, n_fin) = ssm.chunked_gla(*map(_t, ins), chunk=4,
                                        normalize=True,
                                        state=tuple(map(_t, st)))
    ry, (rs, rn) = _r_chunked_gla(*ins, chunk=4, normalize=True, state=st)
    _close(y, ry, what="y")
    _close(s_fin, rs, what="S")
    _close(n_fin, rn, what="n")


def test_chunked_gla_in_bfloat16_casts_where_repro_casts():
    rng = np.random.default_rng(6)
    q, k, v, ld, g = _gla_inputs(rng, s=16)
    tb = [_t(a).bfloat16() for a in (q, k, v)]
    y, (s_fin, _) = ssm.chunked_gla(*tb, _t(ld), _t(g), chunk=4,
                                    normalize=True)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ry, (rs, _) = _r_chunked_gla(*jb, ld, g, chunk=4, normalize=True)
    assert y.dtype == torch.bfloat16 and s_fin.dtype == torch.float32
    _close(y.float(), np.asarray(ry, np.float32), tol=2e-2, what="y")
    _close(s_fin, rs, tol=2e-2, what="S")


def _gla_sequential(q, k, v, log_decay, gate, normalize):
    """``tests/test_mixers.py``'s float64 recurrence."""
    b, s, h, dk = q.shape
    st_ = np.zeros((b, h, dk, v.shape[-1]))
    n = np.zeros((b, h, dk))
    ys = []
    for t in range(s):
        d = np.exp(log_decay[:, t].astype(np.float64))
        g = np.exp(gate[:, t].astype(np.float64))
        kt, vt, qt = (a[:, t].astype(np.float64) for a in (k, v, q))
        st_ = d[..., None, None] * st_ + g[..., None, None] * np.einsum(
            "bhd,bhv->bhdv", kt, vt)
        n = d[..., None] * n + g[..., None] * kt
        y = np.einsum("bhd,bhdv->bhv", qt, st_)
        if normalize:
            denom = np.abs(np.einsum("bhd,bhd->bh", qt, n))
            y = y / np.maximum(denom, 1.0)[..., None]
        ys.append(y)
    return np.stack(ys, axis=1), st_


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk", [2, 4, 16])
def test_chunked_gla_matches_sequential(normalize, chunk):
    """The twin of ``tests/test_mixers.py::test_chunked_gla_matches_sequential``
    (2e-4)."""
    rng = np.random.default_rng(0)
    q, k, v, ld, g = _gla_inputs(rng)
    y, (s_fin, _) = ssm.chunked_gla(*map(_t, (q, k, v, ld, g)), chunk=chunk,
                                    normalize=normalize)
    y_ref, s_ref = _gla_sequential(q, k, v, ld, g, normalize)
    _close(y, y_ref, tol=2e-4)
    _close(s_fin, s_ref, tol=2e-4)


def test_gla_decode_step_matches_chunked_tail():
    """The twin of ``tests/test_mixers.py``'s decode-tail check (1e-4)."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(_np(rng, 1, 8, 2, 3)) for _ in range(3))
    ld = -torch.abs(_t(_np(rng, 1, 8, 2)))
    g = _t(_np(rng, 1, 8, 2)) * 0.3
    y_all, _ = ssm.chunked_gla(q, k, v, ld, g, chunk=4, normalize=True)
    _, state = ssm.chunked_gla(q[:, :-1], k[:, :-1], v[:, :-1], ld[:, :-1],
                               g[:, :-1], chunk=4, normalize=True)
    y_t, _ = ssm.gla_decode_step(q[:, -1], k[:, -1], v[:, -1], ld[:, -1],
                                 g[:, -1], state, normalize=True)
    _close(y_t, y_all[:, -1].numpy(), tol=1e-4)


@BOTH
@pytest.mark.parametrize("normalize", [False, True])
def test_gla_decode_step_matches_repro(jax_dtype, normalize):
    rng = np.random.default_rng(2)
    q, k, v = (_np(rng, 2, 3, 4, dtype=jax_dtype) for _ in range(3))
    ld = -np.abs(_np(rng, 2, 3, dtype=jax_dtype))
    g = _np(rng, 2, 3, scale=0.3, dtype=jax_dtype)
    st = (_np(rng, 2, 3, 4, 4), _np(rng, 2, 3, 4))
    y, (s_new, n_new) = ssm.gla_decode_step(
        *map(_t, (q, k, v, ld, g)), tuple(map(_t, st)), normalize=normalize)
    ry, (rs, rn) = r_ssm.gla_decode_step(q, k, v, ld, g, st,
                                         normalize=normalize)
    _close(y, ry, what="y")
    _close(s_new, rs, what="S")
    _close(n_new, rn, what="n")


def test_masked_exponents_give_finite_gradients():
    """Decays summing past float32's exponent range within a chunk: the
    port masks the within-chunk exponents before ``exp``, so the gradient
    stays finite where ``repro``'s ``0 * exp(large)`` is a NaN (ROADMAP.md
    Queue 3); the forward values agree."""
    rng = np.random.default_rng(3)
    ins = list(_gla_inputs(rng, s=8))
    ins[3] = np.full(ins[3].shape, -30.0, np.float32)  # exp(7 * 30) overflows
    leaves = [_t(a).requires_grad_() for a in ins]
    y, _ = ssm.chunked_gla(*leaves, chunk=8)
    y.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    _close(y, _r_chunked_gla(*ins, chunk=8)[0])

    def r_loss(*a):
        return jnp.sum(r_ssm.chunked_gla(*a, chunk=8)[0])

    r_grads = jax.jit(jax.grad(r_loss, argnums=(0, 1, 2, 3, 4)),
                      compiler_options=FAST_COMPILE)(*ins)
    # The decays' and gates' gradients (q, k and v do not reach the exp).
    assert all(bool(jnp.isfinite(a).all()) for a in r_grads[:3])
    assert not all(bool(jnp.isfinite(a).all()) for a in r_grads[3:])


# ---------------------------------------------------------------------------
# Convolutions, Mamba2, mLSTM, sLSTM
# ---------------------------------------------------------------------------


@BOTH
def test_causal_conv4_and_its_step_match_repro(jax_dtype):
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 9, 6, dtype=jax_dtype)
    w, b = _np(rng, 6, 4, dtype=jax_dtype), _np(rng, 6, dtype=jax_dtype)
    _close(ssm.causal_conv4(_t(x), _t(w), _t(b)), r_ssm.causal_conv4(x, w, b))
    state = _np(rng, 2, 3, 6, dtype=jax_dtype)
    y, st = ssm.causal_conv4_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    ry, rst = r_ssm.causal_conv4_step(x[:, 0], state, w, b)
    _close(y, ry)
    _close(st, rst)


def test_param_tables_match_repro():
    _tables_equal(ssm.mamba2_param_table(ssm.Mamba2Config(64, 8, 2, 16, 8)),
                  r_ssm.mamba2_param_table(
                      r_ssm.Mamba2Config(64, 8, 2, 16, 8)))
    _tables_equal(xlstm.mlstm_param_table(xlstm.MLSTMConfig(64, 4)),
                  r_xlstm.mlstm_param_table(r_xlstm.MLSTMConfig(64, 4)))
    _tables_equal(xlstm.slstm_param_table(xlstm.SLSTMConfig(64, 4)),
                  r_xlstm.slstm_param_table(r_xlstm.SLSTMConfig(64, 4)))
    assert xlstm.GATE_CLAMP == r_xlstm.GATE_CLAMP


def _module_case(name, jax_dtype, s=13):
    """(port config, repro config, port fn, repro fn, decode fns, params,
    x) of one recurrent module; ``s = 13`` runs chunks of one."""
    rng = np.random.default_rng(len(name))
    if name == "mamba2":
        args = (32, 8, 2, 16, 8)
        cfg, rcfg = ssm.Mamba2Config(*args), r_ssm.Mamba2Config(*args)
        fns = (ssm.mamba2, r_ssm.mamba2, ssm.mamba2_decode,
               r_ssm.mamba2_decode)
        table = ssm.mamba2_param_table(cfg)
    elif name == "mlstm":
        cfg, rcfg = xlstm.MLSTMConfig(32, 4, chunk=8), r_xlstm.MLSTMConfig(
            32, 4, chunk=8)
        fns = (xlstm.mlstm, r_xlstm.mlstm, xlstm.mlstm_decode,
               r_xlstm.mlstm_decode)
        table = xlstm.mlstm_param_table(cfg)
    else:
        cfg, rcfg = xlstm.SLSTMConfig(32, 4), r_xlstm.SLSTMConfig(32, 4)
        fns = (xlstm.slstm, r_xlstm.slstm, xlstm.slstm_decode,
               r_xlstm.slstm_decode)
        table = xlstm.slstm_param_table(cfg)
    p = _params(rng, table, jax_dtype)
    x = _np(rng, 2, s + 1, 32, dtype=jax_dtype)
    return cfg, rcfg, fns, p, x


@BOTH
@pytest.mark.parametrize("name", ["mamba2", "mlstm", "slstm"])
def test_recurrent_module_and_its_decode_match_repro(jax_dtype, name):
    """Prefill of 13 tokens (the chunked modules at chunks of one), its
    cache payload, then one decode step from it; each against ``repro``."""
    cfg, rcfg, (fwd, r_fwd, dec, r_dec), p, x = _module_case(name, jax_dtype)
    r_fwd, r_dec = (jax.jit(f, static_argnums=0,
                            compiler_options=FAST_COMPILE)
                    for f in (r_fwd, r_dec))
    tp = {k: _t(v) for k, v in p.items()}
    y, payload = fwd(cfg, tp, _t(x[:, :-1]))
    ry, r_payload = r_fwd(rcfg, p, x[:, :-1])
    _close(y, ry, what="y")
    if name == "slstm":
        payload, r_payload = {"carry": list(payload)}, {
            "carry": list(r_payload)}
    _tree_close(payload, r_payload, what="payload")
    out, new = dec(cfg, tp, _t(x[:, -1:]), payload)
    r_out, r_new = r_dec(rcfg, p, x[:, -1:], r_payload)
    _close(out, r_out, what="decode")
    _tree_close(new, r_new, what="decode cache")
    # The decode step continues the prefill: prefill of all 14 tokens.
    full, _ = fwd(cfg, tp, _t(x))
    _close(out[:, 0], full[:, -1].detach().numpy(), tol=1e-4,
           what="decode vs prefill")


def _autograd_loop(cfg, wx, r, b, carry):
    """The sLSTM loop step by step under autograd: the reference for the
    scan's own backward."""
    h, c, n, m = carry
    hs = []
    for t in range(wx.shape[1]):
        h, c, n, m = xlstm._cell(xlstm._gates(cfg, wx[:, t], h, r, b), c, n,
                                 m)
        hs.append(h.to(wx.dtype))
    return torch.stack(hs, 1), (h, c, n, m)


def test_slstm_scan_backward_equals_autograd_of_the_loop():
    """The scan's own backward (local derivatives at once, the carry's
    gradients as a reverse loop) against autograd through the loop, for
    the outputs and the final carry, float32 (the gates are float32 in
    both): the same forward values, gradients within 1e-5."""
    cfg = xlstm.SLSTMConfig(16, 4)
    rng = np.random.default_rng(9)
    leaves = [torch.tensor(_np(rng, *shape, scale=sc), requires_grad=True)
              for shape, sc in (((2, 11, 64), 1.0), ((4, 4, 16), 0.5),
                                ((64,), 0.5))]
    carry = tuple(torch.tensor(_np(rng, 2, 16)) for _ in range(4))
    weights = [torch.tensor(_np(rng, 2, 11, 16))] + [
        torch.tensor(_np(rng, 2, 16)) for _ in range(3)]
    outs, grads = [], []
    for fn in (xlstm._slstm_scan, _autograd_loop):
        hs, out = fn(cfg, *leaves, carry)
        loss = sum((w * v).sum() for w, v in zip(weights, (hs, *out[:3])))
        outs.append([hs.detach(), *(x.detach() for x in out)])
        grads.append(torch.autograd.grad(loss, leaves))
    for got, ref in zip(*outs):
        assert torch.equal(got, ref)
    for got, ref in zip(*grads):
        _close(got, ref.numpy(), what="gradient")


def test_slstm_carry_starts_at_minus_1e30_and_stays_float32():
    cfg = xlstm.SLSTMConfig(32, 4)
    carry = xlstm.slstm_init_carry(cfg, 3)
    ref = r_xlstm.slstm_init_carry(r_xlstm.SLSTMConfig(32, 4), 3)
    for a, b in zip(carry, ref):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert float(carry[3][0, 0]) == float(np.float32(-1e30))
    _, _, _, p, x = _module_case("slstm", "float32", s=4)
    tp = {k: _t(v).bfloat16() for k, v in p.items()}
    y, out = xlstm.slstm(cfg, tp, _t(x).bfloat16())
    assert y.dtype == torch.bfloat16
    assert all(c.dtype == torch.float32 for c in out)


# ---------------------------------------------------------------------------
# The whole reduced models (shared with tests/test_torch_moe_mla.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str) -> dict:
    """``repro``'s outputs on ``make_pair(arch)`` in ``dtype``: one
    compiled program for the loss and prefill, one decode step run STEPS
    times greedily, and one program for the loss's gradients (taken in
    float32 parameters cast to ``dtype``, as repro's train step does)."""
    pair = make_pair(arch)
    r_params, _ = pair.params(dtype)
    model = pair.r_model

    def serve(p, b):
        return model.loss(p, b)[0], model.prefill(p, b, SMAX)

    jdt = DTYPES[dtype][0]

    def loss_fn(p, b):
        return model.loss(r_cast_tree(p, jdt), b)[0]

    # bfloat16 keeps XLA's default passes: they change where its fused
    # elementwise chains round to bfloat16.
    opts = FAST_COMPILE if dtype == "float32" else None
    loss, run = jax.jit(serve, compiler_options=opts)(r_params,
                                                       pair.r_batch())
    step = jax.jit(model.decode_step, compiler_options=opts)
    runs, toks = [run], []
    for i in range(STEPS):
        toks.append(jnp.argmax(runs[-1][0], axis=-1).astype(jnp.int32))
        runs.append(step(r_params, runs[-1][1], toks[-1],
                         jnp.asarray(S + i, jnp.int32)))
    g_loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                            compiler_options=opts)(pair.r_params,
                                                   pair.r_batch())
    return dict(loss=loss, runs=runs, toks=[np.asarray(t) for t in toks],
                g_loss=g_loss, grads=grads)


def _caches_from_reference(caches, dtype=None):
    """``repro``'s cache tree as the port's (the same layout), bitwise, or
    cast to ``dtype``."""
    out = jax.tree.map(lambda a: _tensor(a, "cpu"), caches)
    return out if dtype is None else cast_tree(out, dtype)


def _port_serve(pair, params, batch, toks, ref_runs=None, dtype=None):
    """Prefill, then a decode step a token of ``toks``: each step's logits
    and caches (a copy of each but the last: decode writes in place).
    With ``ref_runs`` (``repro``'s), each step starts from ``repro``'s
    caches of the step before, in ``dtype``."""
    runs = [pair.model.prefill(params, batch, SMAX)]
    for i, tok in enumerate(toks):
        caches = (jax.tree.map(torch.clone, runs[-1][1]) if ref_runs is None
                  else _caches_from_reference(ref_runs[i][1], dtype))
        logits, caches = pair.model.decode_step(
            params, caches, torch.as_tensor(np.array(tok)).long(), S + i)
        runs.append((logits, caches))
    return runs


def check_serving(arch: str, dtype: str):
    """The loss, prefill's last logits and every cache tensor, and STEPS
    decode steps teacher-forced with repro's tokens (each step's logits,
    the caches after the last) against ``reference``.  In float32 the
    decode steps run from the port's own prefill; in bfloat16 each starts
    from ``repro``'s caches of the step before (bfloat16 rounding in these
    reduced recurrent models compounds chaotically from step to step, in
    either package: ``python tests/test_torch_ssm.py``), so each step's
    function is held on the same input."""
    pair = make_pair(arch)
    ref = reference(arch, dtype)
    _, p_params = pair.params(dtype)
    with torch.no_grad():
        loss, metrics = pair.model.loss(p_params, pair.p_batch())
    assert_loss_close(loss, ref["loss"], dtype)
    chain = dtype == "float32"
    runs = _port_serve(pair, p_params, pair.p_batch(), ref["toks"],
                       None if chain else ref["runs"])
    exact = _port_serve(pair, pair.exact_params(),
                        pair.p_batch(torch.float64), ref["toks"],
                        None if chain else ref["runs"], torch.float64)
    x = BF16_X.get(arch, 1.0)
    for i, ((lg, _), (r_lg, _), (e_lg, _)) in enumerate(
            zip(runs, ref["runs"], exact)):
        assert lg.dtype == torch.float32
        assert_model_close(lg, r_lg, arch, dtype,
                           "prefill logits" if i == 0 else f"decode {i}",
                           e_lg, x * SHARP_X, x)
    for i in (0, -1):
        caches = runs[i][1]
        assert jax.tree.structure(jax.tree.map(lambda _: 0, caches)) \
            == jax.tree.structure(jax.tree.map(lambda _: 0,
                                               ref["runs"][i][1]))
        assert_tree_close(caches, ref["runs"][i][1], arch, dtype,
                          "prefill cache" if i == 0 else "decode cache",
                          exact[i][1], x * SHARP_X, x)
    return metrics


def _grads(pair, dtype):
    model = pair.model
    stacked = {k: v.detach().clone() for k, v in
               model.stacked_dict().items()}

    def loss_fn(p, b):
        return model.loss(model.unstack(cast_tree(p, dtype)), b)

    batch = pair.p_batch(None if dtype != torch.float64 else dtype)
    loss, _, grads = accumulated_grads(loss_fn, stacked, batch, 1)
    return float(loss), grads


def _flat(tree, keys):
    return np.concatenate([f64(tree[k]).ravel() for k in keys])


def check_grads(arch: str, dtype: str):
    """One train step's loss and gradients against ``reference`` (the
    port's gradient keys are ``repro``'s stacked keys).  float32: every
    leaf within GRAD_TOL of its max |g|.  bfloat16: the whole gradient,
    as one vector, within max(BF16_GRAD_TOL, BF16_GRAD_X x repro's
    distance from the port's float64 gradient) of repro's, relative L2,
    and finite (per leaf, a bfloat16 gradient is rounding noise wherever
    it is small: both packages' are over 100% of max |g| from float64 on
    some of zamba2's leaves)."""
    pair = make_pair(arch)
    ref = reference(arch, dtype)
    loss, grads = _grads(pair, DTYPES[dtype][1])
    assert_loss_close(loss, ref["g_loss"], dtype)
    assert sorted(grads) == sorted(ref["grads"])
    if dtype == "float32":
        for key, g in grads.items():
            r = f64(ref["grads"][key])
            err = float(np.abs(f64(g) - r).max())
            assert err <= GRAD_TOL * max(float(np.abs(r).max()), 1e-30), (
                key, err)
        return
    keys = sorted(grads)
    got, r = _flat(grads, keys), _flat(ref["grads"], keys)
    e = _flat(_grads(pair, torch.float64)[1], keys)
    assert np.isfinite(got).all()
    norm = np.linalg.norm
    bound = max(BF16_GRAD_TOL, BF16_GRAD_X * norm(r - e) / norm(e))
    err = norm(got - r) / norm(r)
    assert err <= bound, (arch, err, bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_serving_matches_repro(arch, dtype):
    metrics = check_serving(arch, dtype)
    assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_match_repro(arch, dtype):
    check_grads(arch, dtype)


def test_zamba2_shares_one_attention_set_and_keeps_a_cache_a_position():
    """zamba2's ``attn_shared`` block: one ``shared/attn_shared/...`` set,
    unstacked, read at each position that names it (its gradient is the
    sum over the uses: held to repro's above), and one KV cache a
    position."""
    pair = make_pair("zamba2-2.7b")
    model, cfg = pair.model, pair.model.cfg
    shared = {name: ref for name, ref in model.reference_names().items()
              if name.startswith("shared/")}
    assert shared and all(row is None and key == name
                          for name, (key, row) in shared.items())
    assert not any("attn_shared" in n for n in model.reference_names()
                   if not n.startswith("shared/"))
    p = model.param_dict()
    repeat, kinds = cfg.pattern[0]
    for li in range(repeat):
        layer = model._layer_params(p, "dec", 0, li)
        blk = layer[f"b{kinds.index('attn_shared')}:attn_shared"]
        assert blk["attn/wq"] is p["shared/attn_shared/attn/wq"]
    spec = model.cache_spec(2, SMAX, torch.float32)
    assert spec[0]["b5:attn_shared"]["k"].shape[0] == repeat


def test_prefill_then_decode_continues_a_full_prefill():
    """Prefill of S - 1 tokens and one decode step against prefill of S,
    float32, the port alone (``tests/test_archs_smoke.py``'s 2e-4 of max
    |logit| for these recurrent configs)."""
    for arch in ARCHS:
        pair = make_pair(arch)
        p = pair.model.param_dict()
        batch = pair.p_batch()
        full, _ = pair.model.prefill(p, batch, SMAX)
        head = {k: v[:, :-1] for k, v in batch.items()}
        _, caches = pair.model.prefill(p, head, SMAX)
        step, _ = pair.model.decode_step(p, caches, batch["tokens"][:, -1],
                                         S - 1)
        err = float((step - full).abs().max() / full.abs().max())
        assert err <= 2e-4, (arch, err)


# ---------------------------------------------------------------------------
# Where the whole-model tolerances come from
# ---------------------------------------------------------------------------


def measure(arch: str, seed: int) -> dict:
    """The largest ratio, over the logits of prefill and each decode step
    and every cache tensor, of the port's bfloat16 distance from repro's to
    max(6e-2 of max |x|, SHARP_X x repro's distance from the port's
    float64 run) (what BF16_X must exceed); and the whole gradient's relative L2
    distances (port-repro, repro-float64, port-float64) in bfloat16 and
    each float32 gradient leaf's worst error against its max |g|."""
    global make_pair
    was = make_pair

    def make_pair(a, s=seed):  # noqa: F811  (the seed's pair)
        return was(a, s)

    reference.cache_clear()
    try:
        pair = make_pair(arch)
        ref = reference(arch, "bfloat16")
        _, params = pair.params("bfloat16")
        runs = _port_serve(pair, params, pair.p_batch(), ref["toks"],
                           ref["runs"])
        exact = _port_serve(pair, pair.exact_params(),
                            pair.p_batch(torch.float64), ref["toks"],
                            ref["runs"], torch.float64)
        ratio = 0.0
        for run, r_run, e_run in zip(runs, ref["runs"], exact):
            for a, b, c in zip(*(jax.tree.leaves(list(x))
                                 for x in (run, r_run, e_run))):
                a, b, c = f64(a), f64(b), f64(c)
                floor = 6e-2 * max(float(np.abs(b).max()), 1e-30)
                ratio = max(ratio, float(np.abs(a - b).max()) / max(
                    floor, SHARP_X * float(np.abs(b - c).max())))
        keys = sorted(ref["grads"])
        g = _flat(_grads(pair, torch.bfloat16)[1], keys)
        r, e = _flat(ref["grads"], keys), _flat(
            _grads(pair, torch.float64)[1], keys)
        norm = np.linalg.norm
        l2 = (norm(g - r) / norm(r), norm(r - e) / norm(e),
              norm(g - e) / norm(e))
        ref32 = reference(arch, "float32")
        g32 = _grads(pair, torch.float32)[1]
        leaf = max(float(np.abs(f64(g32[k]) - f64(ref32["grads"][k])).max())
                   / max(float(np.abs(f64(ref32["grads"][k])).max()), 1e-30)
                   for k in keys)
    finally:
        make_pair = was
        reference.cache_clear()
    return {"bf16 ratio": ratio, "bf16 grad L2 p-r": l2[0],
            "r-64": l2[1], "p-64": l2[2], "f32 grad leaf": leaf}


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ssm.py \
    #     [ARCH...]  (seeds 0-2)
    import sys

    jax.config.update("jax_enable_x64", False)
    for arch in sys.argv[1:] or ARCHS:
        for seed in range(3):
            got = measure(arch, seed)
            print(f"{arch} seed {seed}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in got.items()), flush=True)
