"""The language model's modules and the whole model against repro's, on the CPU.

The port's configs, parameter tables (all ten configs), ``models.common``,
the chunked, decode and cross attention, and ``LanguageModel`` (``loss``,
``prefill``'s last logits and every cache tensor) of the six
attention-family configs at reduced width, held against ``repro`` on the
same numpy-seeded inputs, with ``repro``'s own weights carried across by
``interop.params_from_reference``.  Decode and the launcher are in
``tests/test_torch_lm_serve.py``; the other four configs' block kinds
(Mamba2 and zamba2's shared attention, mLSTM and sLSTM, MoE, MLA) and
their whole models in ``tests/test_torch_ssm.py`` and
``tests/test_torch_moe_mla.py``.

Tolerances, from ``python tests/test_torch_lm.py 0 1 2`` (``measure``:
the port against repro, and each against the port's float64 run of the
same weights, seeds 0-2; each tolerance is stated where it is used):

- modules: float32 1e-5 (absolute on O(1) values, relative elsewhere);
- the whole model in float32: 3e-4 of max |logit| for logits, of max |x|
  for each cache tensor; measured at most 4.3e-5 and 2.2e-5.
  llama-vision's reduced model (ten layers, sharp attention) amplifies
  float32 rounding: each package is up to 3.0e-3 of max |logit| from the
  float64 run, the two up to 1.7e-3 apart, so it is held to 5e-3; the
  loss to 1e-5 of max(1, |loss|) (at most 1.7e-5 of a loss of ~2e-3);
- bfloat16: 6e-2 of max |logit| / |x|, or, where repro's own bfloat16 run
  is farther than that from the float64 run, 1.25 times that distance
  (the packages then agree better than either agrees with float64:
  measured at most 0.9 of it; whisper, llama-vision); the loss to 2e-2
  of max(1, |loss|).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import registry as r_registry
from repro.models import attention as r_attn
from repro.models import blocks as r_blocks
from repro.models import common as r_common
from repro.models import mlp as r_mlp
from repro.models.lm import LanguageModel as RLanguageModel
from repro.train.steps import cast_tree as r_cast_tree
from repro_torch.configs import base as p_base
from repro_torch.configs import registry as p_registry
from repro_torch.interop import params_from_reference
from repro_torch.models import attention, blocks, common, mlp, params
from repro_torch.models.lm import LanguageModel
from repro_torch.train.steps import cast_tree

#: The six attention-family configs (held whole here).
ARCHS = ("gemma2-2b", "whisper-large-v3", "llama-3.2-vision-90b",
         "granite-20b", "codeqwen1.5-7b", "starcoder2-7b")
#: The other four configs and the first block kind of each outside the
#: attention family (held whole in tests/test_torch_ssm.py and
#: tests/test_torch_moe_mla.py).
NEW_KINDS = {"deepseek-v3-671b": "mla", "kimi-k2-1t-a32b": "attn_moe",
             "zamba2-2.7b": "mamba", "xlstm-125m": "mlstm"}
#: Prompt length (40 = 4 chunks of 10 under the reduced attn_chunk of 16,
#: past the reduced window of 16), cache length, batch.
B, S, SMAX = 2, 40, 48
MODULE_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: The ill-conditioned reduced config (see the module docstring).
SHARP = "llama-3.2-vision-90b"


def model_tol(arch: str, dtype: str) -> float:
    """Logit and cache tolerance, relative to the reference's max |x|."""
    if dtype == "float32":
        return 5e-3 if arch == SHARP else 3e-4
    return 6e-2


LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: In bfloat16 the bound is at least SHARP_X * |repro - float64|.
SHARP_X = 1.25


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    """repro's LM runs in JAX's default 32-bit mode here, whatever an
    earlier test file on this worker left set."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


# ---------------------------------------------------------------------------
# Shared set-up (also used by tests/test_torch_lm_serve.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Pair:
    """One reduced config in both packages with repro's weights."""

    arch: str
    cfg: object  # repro's ModelConfig
    r_model: RLanguageModel
    r_params: dict  # float32 jax arrays
    model: LanguageModel  # the port's, on the CPU, repro's weights loaded
    batch: dict  # numpy

    def r_batch(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}

    def p_batch(self, dtype=None):
        out = {}
        for k, v in self.batch.items():
            t = torch.as_tensor(v)
            if t.is_floating_point() and dtype is not None:
                t = t.to(dtype)
            out[k] = t.long() if not t.is_floating_point() else t
        return out

    def params(self, dtype: str):
        jdt, tdt = DTYPES[dtype]
        return (r_cast_tree(self.r_params, jdt),
                cast_tree(self.model.param_dict(), tdt))

    def exact_params(self):
        return cast_tree(self.model.param_dict(), torch.float64)


@functools.lru_cache(maxsize=None)
def make_pair(arch: str, seed: int = 0) -> Pair:
    cfg = r_registry.reduced_config(r_registry.get_config(arch))
    r_model = RLanguageModel(cfg)
    r_params = r_model.init(jax.random.PRNGKey(seed))
    model = LanguageModel(
        p_registry.reduced_config(p_registry.get_config(arch)), device="cpu")
    params_from_reference(model, {k: np.array(v) for k, v in r_params.items()})
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["images"] = (rng.standard_normal((B, cfg.img_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    return Pair(arch, cfg, r_model, r_params, model, batch)


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def assert_model_close(got, ref, arch, dtype, what, exact,
                       sharp_x=SHARP_X, scale=1.0) -> float:
    """Hold the port's ``got`` to repro's ``ref`` at ``scale`` x
    ``model_tol`` of max |ref|; in bfloat16 at least at ``sharp_x`` times
    repro's distance from ``exact`` (the port's float64 run).  Returns the
    absolute bound used."""
    got, ref = f64(got), f64(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - ref).max())
    bound = scale * model_tol(arch, dtype) * float(np.abs(ref).max())
    if dtype == "bfloat16":
        bound = max(bound, sharp_x * float(np.abs(ref - f64(exact)).max()))
    assert err <= bound, f"{arch} {dtype} {what}: {err:.3e} > {bound:.3e}"
    return bound


def assert_loss_close(loss, ref, dtype):
    err = abs(float(loss) - float(ref)) / max(1.0, abs(float(ref)))
    assert err <= LOSS_TOL[dtype], (dtype, float(loss), float(ref))


def assert_tree_close(got, ref, arch, dtype, what, exact, sharp_x=SHARP_X,
                      scale=1.0):
    g, r, e = (jax.tree.leaves(t) for t in (got, ref, exact))
    assert len(g) == len(r) == len(e), what
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    for path, a, b, c in zip(paths, g, r, e):
        assert tuple(a.shape) == tuple(b.shape), (what, path)
        assert_model_close(a, b, arch, dtype, f"{what} {path}", c, sharp_x,
                           scale)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


# ---------------------------------------------------------------------------
# Configs and parameter tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(r_registry.ARCHS))
def test_configs_equal_repro_field_for_field(arch):
    ours = p_registry.get_config(arch)
    ref = r_registry.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(p_registry.reduced_config(ours))
            == dataclasses.asdict(r_registry.reduced_config(ref)))
    assert ours.resolved_head_dim == ref.resolved_head_dim
    for name, shape in r_base.SHAPES.items():
        assert dataclasses.asdict(p_base.SHAPES[name]) == dataclasses.asdict(
            shape)
        assert (p_base.shape_applicable(ours, p_base.SHAPES[name])
                == r_base.shape_applicable(ref, shape))
    assert sorted(p_registry.ARCHS) == sorted(r_registry.ARCHS)


def test_unknown_arch_is_refused_as_in_repro():
    with pytest.raises(KeyError, match="unknown arch"):
        p_registry.get_config("gpt-5")


@pytest.mark.parametrize("arch", sorted(r_registry.ARCHS))
def test_param_table_and_n_params_at_full_width(arch):
    """From the tables alone (a ``meta`` model allocates nothing)."""
    ours = LanguageModel(p_registry.get_config(arch), device="meta")
    ref = RLanguageModel(r_registry.get_config(arch))
    assert ours.n_params() == ref.n_params()
    assert {k: dataclasses.astuple(v) for k, v in ours.param_table().items()} \
        == {k: (v.shape, v.axes, v.init, v.fan_in)
            for k, v in ref.param_table().items()}
    # The port's per-layer parameters add up to the same count, and each
    # maps to one row of repro's stacked key.
    assert sum(math.prod(p.shape) for p in ours.param_dict().values()) \
        == ref.n_params()
    rows = {}
    for key, row in ours.reference_names().values():
        rows.setdefault(key, []).append(row)
    table = ref.param_table()
    for key, got in rows.items():
        want = [None] if "/g" not in key else list(range(table[key].shape[0]))
        assert sorted(got, key=lambda r: -1 if r is None else r) == want, key


@pytest.mark.parametrize("arch, kind", sorted(NEW_KINDS.items()))
def test_unported_kind_is_refused_when_the_model_is_built(arch, kind):
    """No kind is refused any more: each of the four configs builds at
    reduced width with repro's table, each of its kinds' block tables is
    repro's, and a kind repro does not know raises repro's ValueError."""
    cfg = p_registry.reduced_config(p_registry.get_config(arch))
    ref_cfg = r_registry.reduced_config(r_registry.get_config(arch))
    model = LanguageModel(cfg, device="cpu")
    assert {k: dataclasses.astuple(v) for k, v in model.param_table().items()} \
        == {k: (v.shape, v.axes, v.init, v.fan_in)
            for k, v in RLanguageModel(ref_cfg).param_table().items()}
    for k in sorted({k for _, ks in cfg.pattern for k in ks} | {kind}):
        assert {p: dataclasses.astuple(v) for p, v in
                blocks.block_param_table(cfg, k).items()} == {
            p: (v.shape, v.axes, v.init, v.fan_in)
            for p, v in r_blocks.block_param_table(ref_cfg, k).items()}, k
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.block_param_table(cfg, "gru")


def test_model_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = p_registry.reduced_config(p_registry.get_config("gemma2-2b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanguageModel(cfg)


def test_params_from_reference_checks_names_and_shapes_both_ways():
    flat = {k: np.array(v) for k, v in make_pair("gemma2-2b").r_params.items()}
    model = LanguageModel(
        p_registry.reduced_config(p_registry.get_config("gemma2-2b")),
        device="cpu")
    params_from_reference(model, flat)
    weights = model.param_dict()
    for name, (key, row) in model.reference_names().items():
        src = flat[key] if row is None else flat[key][row]
        assert np.array_equal(weights[name].detach().numpy(), src), name
    key = "dec/g0/b0:attn_local/attn/wq"
    for bad, said in (({k: v for k, v in flat.items() if k != key},
                       "not given"),
                      (dict(flat, extra=np.zeros(3)), "not in the port"),
                      (dict(flat, **{key: flat[key][:1]}), key)):
        with pytest.raises(ValueError, match=said):
            params_from_reference(model, bad)


# ---------------------------------------------------------------------------
# The port's init
# ---------------------------------------------------------------------------


def test_init_follows_repro_rules_and_the_generator_seed():
    cfg = p_registry.reduced_config(p_registry.get_config("whisper-large-v3"))
    model = LanguageModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    table = model.layer_table()
    got = {k: v.detach().clone() for k, v in model.param_dict().items()}
    checked = 0
    for name, decl in table.items():
        w = got[name]
        std = params.init_std(decl)
        if std is None:
            assert decl.init == "zeros" and torch.count_nonzero(w) == 0, name
            continue
        if w.numel() >= 4096:
            assert abs(float(w.std()) / std - 1) < 0.05, (name, decl)
            assert abs(float(w.mean())) < 0.05 * std * 4, name
            checked += 1
    assert checked >= 10
    # Rules: fan-in from shape[-2] (the heads of a (d, h, dh) projection,
    # as repro's _init_one reads it) or fan_in=; output halves the std.
    assert params.init_std(table["dec/g0/0/b0:dec_cross/attn/wq"]) \
        == 1 / math.sqrt(cfg.n_heads)
    assert params.init_std(table["dec/g0/0/b0:dec_cross/mlp/w_up"]) \
        == 1 / math.sqrt(cfg.d_model)
    assert params.init_std(table["dec/g0/0/b0:dec_cross/attn/wo"]) \
        == 0.5 / math.sqrt(cfg.n_heads * cfg.head_dim)
    assert params.init_std(table["embed/tokens"]) == 1.0
    again = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    other = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))
    for name, w in again.param_dict().items():
        assert torch.equal(w, got[name]), name
    assert not torch.equal(other.param_dict()["embed/tokens"],
                           got["embed/tokens"])


# ---------------------------------------------------------------------------
# models.common and models.mlp
# ---------------------------------------------------------------------------


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_norms_softcap_gelu_swiglu_match_repro():
    rng = np.random.default_rng(0)
    x, s, b = _np(rng, 3, 5, 64, scale=3), _np(rng, 64), _np(rng, 64)
    t = torch.as_tensor
    pairs = [
        (common.rms_norm(t(x), t(s)), r_common.rms_norm(x, s)),
        (common.rms_norm(t(x), t(s), 1e-5), r_common.rms_norm(x, s, 1e-5)),
        (common.layer_norm(t(x), t(s), t(b)), r_common.layer_norm(x, s, b)),
        (common.softcap(t(x) * 40, 50.0), r_common.softcap(x * 40, 50.0)),
        (common.gelu(t(x)), r_common.gelu(x)),
        (common.swiglu(t(x), t(b)), r_common.swiglu(x, b)),
    ]
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=MODULE_TOL, atol=MODULE_TOL,
                                   err_msg=str(i))
    # bfloat16 in, bfloat16 out, float32 inside.
    xb = t(x).bfloat16()
    assert common.rms_norm(xb, t(s)).dtype == torch.bfloat16
    np.testing.assert_allclose(
        common.rms_norm(xb, t(s)).float().numpy(),
        np.asarray(r_common.rms_norm(jnp.asarray(x, jnp.bfloat16), s),
                   np.float32), rtol=1e-2, atol=1e-2)
    # gelu is the tanh approximation, not the erf one.
    assert not np.allclose(common.gelu(t(x)).numpy(),
                           torch.nn.functional.gelu(t(x)).numpy(), atol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 1000000.0])
def test_apply_rope_splits_halves_in_float32(theta):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 40, 3, 16, scale=10)
    pos = np.broadcast_to(np.arange(40)[None], (2, 40)).astype(np.int32)
    got = common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    ref = r_common.apply_rope(x, pos, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=MODULE_TOL,
                               atol=MODULE_TOL * 10)
    np.testing.assert_allclose(common.rope_freqs(16, theta).numpy(),
                               np.asarray(r_common.rope_freqs(16, theta)),
                               rtol=MODULE_TOL)
    # Halves, not interleaved pairs: dims d and d + D/2 rotate together.
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = common.apply_rope(torch.as_tensor(one), torch.tensor([[1]]), theta)
    assert rot[..., 8] != 0 and rot[..., 1] == 0
    # bfloat16 in: the angles stay float32, the result is bfloat16.
    xb = common.apply_rope(torch.as_tensor(x).bfloat16(),
                           torch.as_tensor(pos), theta)
    assert xb.dtype == torch.bfloat16
    np.testing.assert_allclose(
        xb.float().numpy(),
        np.asarray(r_common.apply_rope(jnp.asarray(x, jnp.bfloat16), pos,
                                       theta), np.float32),
        rtol=1e-2, atol=1e-1)


@pytest.mark.parametrize("window", [None, 1, 4])
def test_causal_window_mask_matches_repro(window):
    q = np.arange(3, 15)
    k = np.arange(0, 20)
    got = common.causal_window_mask(torch.as_tensor(q), torch.as_tensor(k),
                                    window)
    assert np.array_equal(got.numpy(), np.asarray(
        r_common.causal_window_mask(q, k, window)))
    assert common.NEG_INF == r_common.NEG_INF == -1e30


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_repro(activation):
    rng = np.random.default_rng(2)
    cfg = mlp.MLPConfig(64, 128, activation)
    rcfg = r_mlp.MLPConfig(64, 128, activation)
    assert {k: dataclasses.astuple(v) for k, v in
            mlp.mlp_param_table(cfg).items()} == {
        k: (v.shape, v.axes, v.init, v.fan_in)
        for k, v in r_mlp.mlp_param_table(rcfg).items()}
    p = {k: _np(rng, *d.shape, scale=0.1)
         for k, d in mlp.mlp_param_table(cfg).items()}
    x = _np(rng, 2, 7, 64)
    got = mlp.mlp(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                  torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(r_mlp.mlp(rcfg, p, x)),
                               rtol=MODULE_TOL, atol=MODULE_TOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                chunk_q=16, chunk_k=16)
    base.update(kw)
    return attention.AttnConfig(**base), r_attn.AttnConfig(**base)


def _qkv(rng, sq=40, sk=40, h=4, hkv=2, dh=16):
    return (_np(rng, 2, sq, h, dh, scale=2), _np(rng, 2, sk, hkv, dh, scale=2),
            _np(rng, 2, sk, hkv, dh))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [None, 8])
def test_chunked_attention_matches_repro(window, softcap, causal):
    """GQA with 2 kv heads for 4 query heads, and a length of 40 that
    ``_fit_chunk`` cuts into chunks of 10 under a chunk of 16."""
    assert attention._fit_chunk(40, 16) == 10
    cfg, rcfg = _cfgs(window=window, softcap=softcap, causal=causal)
    q, k, v = _qkv(np.random.default_rng(3))
    got = attention.chunked_attention(cfg, *map(torch.as_tensor, (q, k, v)))
    ref = r_attn.chunked_attention(rcfg, q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=MODULE_TOL,
                               atol=MODULE_TOL)
    # bfloat16 operands: float32 scores and accumulators in both.
    tb = [torch.as_tensor(a).bfloat16() for a in (q, k, v)]
    got = attention.chunked_attention(cfg, *tb)
    ref = r_attn.chunked_attention(rcfg, *(jnp.asarray(a, jnp.bfloat16)
                                           for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_fit_chunk_matches_repro_at_the_full_width_lengths():
    for s, c in ((1500, 1024), (5120, 1024), (5112, 1024), (224, 1024),
                 (216, 1024), (40, 16), (39, 16), (5119, 1024)):
        assert attention._fit_chunk(s, c) == r_attn._fit_chunk(s, c), (s, c)
    assert attention._fit_chunk(1500, 1024) == 750
    # A prime length falls to chunks of one (why the card's consistency
    # check prefills 5112 tokens and decodes 8, not 5119 and 1).
    assert attention._fit_chunk(5119, 1024) == 1


def test_gqa_query_head_reads_kv_head_h_div_rep():
    """Head h pairs with kv head h // rep (``repeat_interleave``); tiling
    the kv heads (``repeat``) pairs the wrong heads."""
    cfg, _ = _cfgs(causal=False, n_heads=6, n_kv_heads=2)
    q, k, v = _qkv(np.random.default_rng(4), sq=8, sk=8, h=6)
    got = attention.chunked_attention(cfg, *map(torch.as_tensor, (q, k, v)))

    def dense(kk, vv):
        qt, kt, vt = (torch.as_tensor(a).permute(0, 2, 1, 3)
                      for a in (q, kk, vv))
        p = torch.softmax(qt @ kt.transpose(-1, -2) / 4.0, dim=-1)
        return (p @ vt).permute(0, 2, 1, 3)

    right = dense(np.repeat(k, 3, axis=2), np.repeat(v, 3, axis=2))
    wrong = dense(np.tile(k, (1, 1, 3, 1)), np.tile(v, (1, 1, 3, 1)))
    np.testing.assert_allclose(got.numpy(), right.numpy(), rtol=MODULE_TOL,
                               atol=MODULE_TOL)
    assert not np.allclose(got.numpy(), wrong.numpy(), atol=1e-2)


def test_skipped_chunk_pairs_are_never_computed():
    """NaN keys and values where every pair is skippable (the future, and
    the past beyond the window) leave the output finite and equal to
    repro's, which skips the same pairs; a NaN in a computed chunk
    reaches the output."""
    cfg, rcfg = _cfgs(window=16)
    q, k, v = _qkv(np.random.default_rng(5))
    # Chunks of 10.  The future: query chunks 0-2 (rows 0-29) skip key
    # chunk 3 (30-39); query chunk 3 computes it.  A masked but computed
    # pair would carry the NaN through p @ v (0 * NaN).
    k[:, 30:] = np.nan
    v[:, 30:] = np.nan
    got = attention.chunked_attention(cfg, *map(torch.as_tensor, (q, k, v)))
    ref = np.asarray(r_attn.chunked_attention(rcfg, q, k, v))
    assert np.isfinite(got[:, :30].numpy()).all()
    np.testing.assert_allclose(got[:, :30].numpy(), ref[:, :30],
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    assert not np.isfinite(got[:, 30:].numpy()).any()
    # Past the window: query chunk 3 (30-39) skips key chunk 0 (0-9) since
    # 9 <= 30 - 16.
    q2, k2, v2 = _qkv(np.random.default_rng(6))
    k2[:, :10] = np.nan
    v2[:, :10] = np.nan
    got = attention.chunked_attention(cfg,
                                      *map(torch.as_tensor, (q2, k2, v2)))
    assert np.isfinite(got[:, 30:].numpy()).all()
    np.testing.assert_allclose(
        got[:, 30:].numpy(),
        np.asarray(r_attn.chunked_attention(rcfg, q2, k2, v2))[:, 30:],
        rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("window, softcap", [(None, None), (8, 50.0)])
def test_decode_attention_matches_repro(window, softcap):
    cfg, rcfg = _cfgs(window=window, softcap=softcap)
    rng = np.random.default_rng(7)
    q = _np(rng, 2, 1, 4, 16, scale=2)
    kc, vc = _np(rng, 2, 48, 2, 16, scale=2), _np(rng, 2, 48, 2, 16)
    for pos in (0, 20, 47):
        got = attention.decode_attention(cfg, torch.as_tensor(q),
                                         torch.as_tensor(kc),
                                         torch.as_tensor(vc), pos)
        ref = r_attn.decode_attention(rcfg, q, kc, vc,
                                      jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)


def test_self_attention_decode_writes_the_cache_in_place():
    cfg, rcfg = _cfgs(window=8, softcap=50.0)
    rng = np.random.default_rng(8)
    p = {k: _np(rng, *d.shape, scale=0.2)
         for k, d in attention.attn_param_table(cfg).items()}
    x = _np(rng, 2, 1, 64)
    cache = {"k": _np(rng, 2, 24, 2, 16), "v": _np(rng, 2, 24, 2, 16)}
    ours = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    before = ours["k"]
    out, new = attention.self_attention_decode(
        cfg, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), ours, 13)
    ref_out, ref_new = r_attn.self_attention_decode(
        rcfg, p, x, cache, jnp.asarray(13, jnp.int32))
    assert new["k"] is before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(),
                                   np.asarray(ref_new[name]),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)


def test_cross_attention_and_its_cached_decode_match_repro():
    cfg, rcfg = _cfgs()
    rng = np.random.default_rng(9)
    p = {k: _np(rng, *d.shape, scale=0.2)
         for k, d in attention.attn_param_table(cfg).items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x, src = _np(rng, 2, 12, 64), _np(rng, 2, 30, 64)
    out, (k, v) = attention.cross_attention(cfg, tp, torch.as_tensor(x),
                                            torch.as_tensor(src))
    ref_out, (rk, rv) = r_attn.cross_attention(rcfg, p, x, src)
    for a, b in ((out, ref_out), (k, rk), (v, rv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=MODULE_TOL,
                                   atol=MODULE_TOL)
    x1 = x[:, :1]
    cache = {"k": k, "v": v}
    got, same = attention.cross_attention_cached(cfg, tp, torch.as_tensor(x1),
                                                 cache)
    ref, _ = r_attn.cross_attention_cached(rcfg, p, x1, {"k": rk, "v": rv})
    assert same is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=MODULE_TOL,
                               atol=MODULE_TOL)


# ---------------------------------------------------------------------------
# The whole model: loss, prefill's last logits and every cache tensor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_loss_prefill_and_caches_match_repro(pair, dtype):
    r_params, p_params = pair.params(dtype)
    # One compiled program for both of repro's calls.
    (r_loss, r_metrics), (r_logits, r_caches) = jax.jit(
        lambda p, b: (pair.r_model.loss(p, b),
                      pair.r_model.prefill(p, b, SMAX)))(r_params,
                                                         pair.r_batch())
    with torch.no_grad():
        loss, metrics = pair.model.loss(p_params, pair.p_batch())
    assert_loss_close(loss, r_loss, dtype)
    assert float(metrics["aux"]) == float(r_metrics["aux"]) == 0.0

    logits, caches = pair.model.prefill(p_params, pair.p_batch(), SMAX)
    assert logits.dtype == torch.float32 and logits.shape == (
        B, pair.cfg.vocab_size)
    exact, exact_caches = pair.model.prefill(
        pair.exact_params(), pair.p_batch(torch.float64), SMAX)
    assert_model_close(logits, r_logits, pair.arch, dtype, "prefill logits",
                       exact)
    # Same layout, and the cache dtype is the params' after the cast.
    assert jax.tree.structure(jax.tree.map(lambda _: 0, caches)) \
        == jax.tree.structure(jax.tree.map(lambda _: 0, r_caches))
    for leaf in jax.tree.leaves(caches):
        assert leaf.dtype == DTYPES[dtype][1]
    assert_tree_close(caches, r_caches, pair.arch, dtype, "prefill cache",
                      exact_caches)
    # Positions past the prompt stay zero.
    for leaf in jax.tree.leaves(caches):
        if leaf.shape[2] == SMAX:
            assert torch.count_nonzero(leaf[:, :, S:]) == 0


# ---------------------------------------------------------------------------
# Where the tolerances come from
# ---------------------------------------------------------------------------


def measure(arch: str, dtype: str, seed: int) -> dict:
    """Largest relative errors of the port against repro (``p-r``) and of
    each against the port's float64 run of the same weights (``r-64``,
    ``p-64``): prefill's last logits and the 6 teacher-forced decode steps'
    (relative to max |logit|), the caches after them (each to its max |x|),
    and the loss."""
    pair = make_pair(arch, seed)
    r_params, p_params = pair.params(dtype)
    exact_params = pair.exact_params()
    b64 = pair.p_batch(torch.float64)
    r_loss = jax.jit(pair.r_model.loss)(r_params, pair.r_batch())[0]
    with torch.no_grad():
        loss = pair.model.loss(p_params, pair.p_batch())[0]
    runs = [jax.jit(pair.r_model.prefill, static_argnums=2)(
        r_params, pair.r_batch(), SMAX),
        pair.model.prefill(p_params, pair.p_batch(), SMAX),
        pair.model.prefill(exact_params, b64, SMAX)]
    r_step = jax.jit(pair.r_model.decode_step)
    out = {"loss p-r": abs(float(loss) - float(r_loss)) / abs(float(r_loss))}

    def note(what, r, p, e):
        scale = float(np.abs(f64(r)).max())
        for key, a, b in (("p-r", p, r), ("r-64", r, e), ("p-64", p, e)):
            err = float(np.abs(f64(a) - f64(b)).max()) / scale
            out[f"{what} {key}"] = max(out.get(f"{what} {key}", 0.0), err)

    note("logits", *(run[0] for run in runs))
    tok = np.asarray(jnp.argmax(runs[0][0], axis=-1)).astype(np.int32)
    for i in range(6):
        r = r_step(r_params, runs[0][1], jnp.asarray(tok),
                   jnp.asarray(S + i, jnp.int32))
        p = pair.model.decode_step(p_params, runs[1][1],
                                   torch.as_tensor(tok).long(), S + i)
        e = pair.model.decode_step(exact_params, runs[2][1],
                                   torch.as_tensor(tok).long(), S + i)
        runs = [r, p, e]
        note("logits", r[0], p[0], e[0])
        tok = f64(r[0]).argmax(-1).astype(np.int32)
    for r, p, e in zip(*(jax.tree.leaves(run[1]) for run in runs)):
        note("caches", r, p, e)
    return out


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py [SEED...]
    import sys

    jax.config.update("jax_enable_x64", False)
    for seed in [int(a) for a in sys.argv[1:]] or [0]:
        for arch in ARCHS:
            for dtype in sorted(DTYPES):
                got = measure(arch, dtype, seed)
                print(f"seed {seed} {arch} {dtype}: " + ", ".join(
                    f"{k} {v:.2e}" for k, v in got.items()), flush=True)
