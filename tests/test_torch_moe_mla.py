"""The MoE and MLA modules and their two models against repro's, on the CPU.

``models/moe.py`` (routing, capacity, dispatch, the shared expert, the
load-balance and z-loss aux) and MLA of ``models/attention.py`` (prefill
through the chunked core, the absorbed decode over the ``(latent,
k_rope)`` cache) held against ``repro``'s twins in float32 and float64;
the twins of ``tests/test_mixers.py``'s MoE routing invariants and
capacity check; routing's order on ties; and the whole reduced
kimi-k2-1t-a32b (GQA + MoE) and deepseek-v3-671b (MLA + MoE) against
``repro`` as ``tests/test_torch_ssm.py`` holds zamba2 and xlstm: the loss,
prefill's last logits and every cache tensor, two decode steps (MoE
decode routes the batch's tokens as one group of capacity 4, so the
port's prefill-then-decode is held against ``repro``'s own
prefill-then-decode, not against a full prefill), one train step's loss
and gradients, float32 and bfloat16.  Last, the twin of
``tests/test_system.py``'s MoE training run.

Tolerances: modules 1e-5 in float32 and float64 (``tests/test_torch_lm.py``'s;
the MoE's routing, an exact function of the logits' order, is bitwise
in both packages on these inputs); the whole models as in
``tests/test_torch_ssm.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from test_torch_lm import _float32_jax  # noqa: F401  (autouse fixture)
from test_torch_ssm import (  # noqa: F401  (fixtures: jax_dtype, autouse)
    BOTH,
    FAST_COMPILE,
    _one_torch_thread,
    _close,
    _np,
    _t,
    _tables_equal,
    check_grads,
    check_serving,
    jax_dtype,
)

from repro.models import attention as r_attn
from repro.models import moe as r_moe
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_synthetic
from repro_torch.models import attention, moe
from repro_torch.models.lm import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step, put_batch

ARCHS = ("kimi-k2-1t-a32b", "deepseek-v3-671b")
D, F, E, K = 16, 32, 8, 2


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_cfgs(**kw):
    base = dict(d_model=D, d_ff=F, n_experts=E, top_k=K, group_size=16)
    base.update(kw)
    return moe.MoEConfig(**base), r_moe.MoEConfig(**base)


def _moe_params(rng, cfg, dtype="float32", scale=0.3):
    return {k: _np(rng, *d.shape, scale=scale, dtype=dtype)
            for k, d in moe.moe_param_table(cfg).items()}


def test_moe_table_capacity_and_groups_match_repro():
    for n_shared in (0, 1, 2):
        cfg, rcfg = _moe_cfgs(n_shared=n_shared)
        _tables_equal(moe.moe_param_table(cfg), r_moe.moe_param_table(rcfg))
    for e, k, f in ((8, 2, 1.25), (384, 8, 1.25), (256, 8, 1.25),
                    (4, 1, 0.1), (4, 1, 8.0)):
        cfg, rcfg = _moe_cfgs(n_experts=e, top_k=k, capacity_factor=f)
        for t in (1, 2, 3, 16, 80, 1024):
            assert moe._capacity(cfg, t) == r_moe._capacity(rcfg, t), (e, t)
    # kimi's prefill of 2 x 2048 tokens: 4 groups of 1024, capacity 28;
    # its decode of 2 tokens: one group of 2, capacity 4.
    kimi = moe.MoEConfig(7168, 2048, 384, 8, n_shared=1)
    assert moe.group_size(kimi, 4096) == 1024
    assert moe._capacity(kimi, 1024) == 28
    assert moe.group_size(kimi, 2) == 2 and moe._capacity(kimi, 2) == 4
    # The group halves until it divides the tokens: 80 -> 16, 40 -> 8.
    assert moe.group_size(_moe_cfgs()[0], 80) == 16
    assert moe.group_size(_moe_cfgs()[0], 40) == 8


@BOTH
@pytest.mark.parametrize("n_shared, capacity_factor", [(0, 1.25), (1, 1.25),
                                                       (1, 0.5)])
def test_moe_output_and_aux_match_repro(jax_dtype, n_shared,
                                        capacity_factor):
    """Three groups of 16 tokens; at capacity factor 0.5 (capacity 4 for
    32 picks over 8 experts) tokens are dropped."""
    cfg, rcfg = _moe_cfgs(n_shared=n_shared, capacity_factor=capacity_factor)
    rng = np.random.default_rng(n_shared * 10 + int(capacity_factor * 4))
    p = _moe_params(rng, cfg, jax_dtype)
    x = _np(rng, 2, 24, D, dtype=jax_dtype)
    y, aux = moe.moe(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    r_y, r_aux = jax.jit(r_moe.moe, static_argnums=0,
                         compiler_options=FAST_COMPILE)(rcfg, p, x)
    assert y.dtype == _t(x).dtype and aux.dtype == torch.float32
    _close(y, r_y, what="y")
    _close(aux, r_aux, what="aux")


def test_routing_takes_the_lower_expert_first_on_ties():
    """Router columns 1, 4 and 6 equal and column 3 equal to column 0: the
    softmax's probabilities tie exactly, and ``jax.lax.top_k`` picks the
    lower expert index first.  A tie at the top-k boundary decides which
    expert a token reaches; the port's routing and output equal repro's."""
    cfg, rcfg = _moe_cfgs(top_k=3, capacity_factor=2.0)
    rng = np.random.default_rng(11)
    p = _moe_params(rng, cfg)
    router = p["router"]
    router[:, 4] = router[:, 1]
    router[:, 6] = router[:, 1]
    router[:, 3] = router[:, 0]
    x = _np(rng, 1, 16, D)
    probs = jax.nn.softmax(jnp.asarray(x[0] @ router), axis=-1)
    r_vals, r_idx = jax.lax.top_k(probs, 3)
    vals, idx = moe.top_k(torch.as_tensor(np.asarray(probs)), 3)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    assert np.array_equal(vals.numpy(), np.asarray(r_vals))
    p_np = np.asarray(probs)
    ties = sum(int(np.sum(row == row[i]) > 1) for row, i in
               zip(p_np, np.asarray(r_idx)[:, -1]))
    assert ties >= 8  # the boundary pick is a tie for most tokens
    y, aux = moe.moe(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    r_y, r_aux = r_moe.moe(rcfg, p, x)
    _close(y, r_y, what="y")
    _close(aux, r_aux, what="aux")


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), e=st.sampled_from([4, 8]),
       k=st.integers(1, 3), tokens=st.sampled_from([8, 32]))
def test_property_moe_routing_invariants(seed, e, k, tokens):
    """The twin of ``tests/test_mixers.py``'s: shape, finite, aux >= 0,
    and a zero input routes nothing."""
    rng = np.random.default_rng(seed)
    d, f = 8, 16
    cfg = moe.MoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k,
                        capacity_factor=1.5, group_size=16)
    p = {"router": _t(_np(rng, d, e)),
         "w_gate": _t(_np(rng, e, d, f, scale=0.1)),
         "w_up": _t(_np(rng, e, d, f, scale=0.1)),
         "w_down": _t(_np(rng, e, f, d, scale=0.1))}
    x = _t(_np(rng, 2, tokens // 2, d))
    y, aux = moe.moe(cfg, p, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0
    y0, _ = moe.moe(cfg, p, torch.zeros_like(x))
    assert float(y0.abs().max()) <= 1e-5


def test_moe_capacity_drops_tokens():
    """The twin of ``tests/test_mixers.py``'s: at capacity factor 0.1 most
    of 64 tokens are dropped (output 0), at 8.0 none is; the port drops the
    same tokens as repro."""
    rng = np.random.default_rng(0)
    d, f, e = 4, 8, 4
    p = {"router": _np(rng, d, e), "w_gate": _np(rng, e, d, f),
         "w_up": _np(rng, e, d, f), "w_down": _np(rng, e, f, d)}
    tp = {k: _t(v) for k, v in p.items()}
    x = _np(rng, 1, 64, d)
    counts = []
    for factor in (8.0, 0.1):
        cfg = moe.MoEConfig(d, f, e, 1, capacity_factor=factor, group_size=64)
        y, _ = moe.moe(cfg, tp, _t(x))
        kept = torch.any(y.abs() > 1e-7, dim=-1)[0]
        r_y, _ = r_moe.moe(r_moe.MoEConfig(d, f, e, 1, capacity_factor=factor,
                                           group_size=64), p, x)
        r_kept = np.any(np.abs(np.asarray(r_y)) > 1e-7, axis=-1)[0]
        assert np.array_equal(kept.numpy(), r_kept)
        counts.append(int(kept.sum()))
    assert counts[0] == 64 and counts[1] < 32


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


MLA = dict(d_model=32, n_heads=4, q_lora_rank=16, kv_lora_rank=8,
           qk_nope_dim=8, qk_rope_dim=4, v_dim=8, chunk_q=8, chunk_k=8)


def _mla_case(dtype="float32", s=20, seed=0):
    cfg, rcfg = attention.MLAConfig(**MLA), r_attn.MLAConfig(**MLA)
    rng = np.random.default_rng(seed)
    p = {k: _np(rng, *d.shape, scale=0.3, dtype=dtype)
         for k, d in attention.mla_param_table(cfg).items()}
    x = _np(rng, 2, s, 32, dtype=dtype)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    return cfg, rcfg, p, x, pos


def test_mla_table_matches_repro():
    cfg, rcfg = attention.MLAConfig(**MLA), r_attn.MLAConfig(**MLA)
    _tables_equal(attention.mla_param_table(cfg),
                  r_attn.mla_param_table(rcfg))
    assert cfg.qk_dim == rcfg.qk_dim == 12


@BOTH
def test_mla_attention_matches_repro(jax_dtype):
    """Prefill of 20 tokens (chunks of 5 under a chunk of 8) with V padded
    from v_dim 8 to qk_dim 12; the output and the cache payload."""
    cfg, rcfg, p, x, pos = _mla_case(jax_dtype)
    y, (latent, k_rope) = attention.mla_attention(
        cfg, {k: _t(v) for k, v in p.items()}, _t(x), _t(pos))
    r_y, (r_latent, r_k_rope) = jax.jit(
        r_attn.mla_attention, static_argnums=0,
        compiler_options=FAST_COMPILE)(rcfg, p, x, pos)
    _close(y, r_y, what="y")
    _close(latent, r_latent, what="latent")
    _close(k_rope, r_k_rope, what="k_rope")


@BOTH
def test_mla_absorbed_decode_matches_repro(jax_dtype):
    """The absorbed decode at three positions of a random 24-position
    cache: the output, and the cache written in place at ``pos``."""
    cfg, rcfg, p, x, _ = _mla_case(jax_dtype, s=1, seed=1)
    rng = np.random.default_rng(2)
    cache = {"latent": _np(rng, 2, 24, 8, dtype=jax_dtype),
             "k_rope": _np(rng, 2, 24, 4, dtype=jax_dtype)}
    tp = {k: _t(v) for k, v in p.items()}
    r_dec = jax.jit(r_attn.mla_attention_decode, static_argnums=0,
                    compiler_options=FAST_COMPILE)
    for pos in (0, 13, 23):
        ours = {k: _t(v.copy()) for k, v in cache.items()}
        before = ours["latent"]
        y, new = attention.mla_attention_decode(cfg, tp, _t(x), ours, pos)
        r_y, r_new = r_dec(rcfg, p, x, cache, jnp.asarray(pos, jnp.int32))
        assert new["latent"] is before
        _close(y, r_y, what=f"y at {pos}")
        for name in ("latent", "k_rope"):
            _close(new[name], r_new[name], what=f"{name} at {pos}")


def test_mla_decode_reads_the_cache_prefill_wrote():
    """Prefill of 19 tokens written into a 24-position cache, then the
    absorbed decode of token 19 against the prefill of all 20 (its last
    position): two different computations of one function (1e-5)."""
    cfg, _, p, x, pos = _mla_case(s=20, seed=3)
    tp = {k: _t(v) for k, v in p.items()}
    full, _ = attention.mla_attention(cfg, tp, _t(x), _t(pos))
    _, (latent, k_rope) = attention.mla_attention(cfg, tp, _t(x[:, :19]),
                                                  _t(pos[:, :19]))
    cache = {"latent": torch.zeros(2, 24, 8), "k_rope": torch.zeros(2, 24, 4)}
    cache["latent"][:, :19] = latent
    cache["k_rope"][:, :19] = k_rope
    y, _ = attention.mla_attention_decode(cfg, tp, _t(x[:, 19:]), cache, 19)
    _close(y[:, 0], full[:, 19].numpy(), what="decode vs prefill")


# ---------------------------------------------------------------------------
# The whole reduced models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_serving_matches_repro(arch, dtype):
    metrics = check_serving(arch, dtype)
    assert float(metrics["aux"]) > 0.0  # the MoE layers' aux


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_match_repro(arch, dtype):
    check_grads(arch, dtype)


def test_moe_model_training_reduces_loss():
    """The twin of ``tests/test_system.py::test_moe_training_reduces_loss``:
    reduced kimi-k2, AdamW(lr=3e-3, weight_decay=0), sequences of 16,
    batch 4, repro's repeating batches (batch i % 4); the loss falls by at
    least 0.3 in 25 steps."""
    cfg = reduced_config(get_config("kimi-k2-1t-a32b"))
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    params = model.stacked_dict()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(model, opt, torch.float32)
    source = make_synthetic(cfg, ShapeConfig("t", 16, 4, "train"), seed=0)
    losses = []
    for i in range(25):
        state, metrics = step(state, put_batch(source.global_batch_at(i % 4),
                                               "cpu"))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, losses[::5]


def test_expert_weights_load_as_four_dimensional_stacked_keys():
    """kimi's stacked expert weights are 4-D ``(layers, experts, d, f)``
    keys of repro's table; each layer's port parameter is a 3-D view of
    its row, loaded bitwise by ``params_from_reference``."""
    from test_torch_lm import make_pair

    pair = make_pair("kimi-k2-1t-a32b")
    key = "dec/g1/b0:attn_moe/moe/w_gate"
    assert pair.r_params[key].ndim == 4
    stacked = pair.model.stacked_dict()[key]
    assert tuple(stacked.shape) == pair.r_params[key].shape
    for li in range(stacked.shape[0]):
        name = f"dec/g1/{li}/b0:attn_moe/moe/w_gate"
        w = pair.model.param_dict()[name]
        assert w.untyped_storage().data_ptr() \
            == stacked.untyped_storage().data_ptr()
        assert np.array_equal(w.detach().numpy(),
                              np.asarray(pair.r_params[key][li]))
    assert dataclasses.asdict(pair.model.cfg)["n_experts"] == 8
