"""The port's optimizers against repro's, on the CPU.

``AdamW``, ``warmup_cosine`` and ``EigenPre.update`` of
``repro_torch.optim`` are held against ``repro.optim``'s on the same numpy
gradients and state over several steps, so that no difference in the
gradients can reach the comparison; the twins of ``tests/test_optim.py``'s
five tests run on the port alone; ``EigenPre``'s eligibility is held
against repro's on the full-width parameter tables (``meta`` tensors, no
allocation).

Tolerances (stated where used): the schedule one float32 ulp of 1.0
(``jnp.cos`` and ``torch.cos`` may round apart by one ulp); AdamW 1e-6
of the parameters' scale and a bitwise ``count``; EigenPre by the
engine's precision (``EIGENPRE_TOL``), holding the rank-k projector
``V^T V``, never raw eigenvectors (their signs differ between solvers).  The EigenPre gradients are seeded with a gap at
k in the gram's spectrum, so that the rank-k subspace is well determined.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.models.lm import LanguageModel as RLanguageModel
from repro.optim import AdamW as RAdamW
from repro.optim import EigenPre as REigenPre
from repro.optim.schedule import warmup_cosine as r_warmup_cosine
from repro_torch.configs import registry as p_registry
from repro_torch.models.lm import param_table
from repro_torch.optim import AdamW, EigenPre, global_norm, warmup_cosine


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    """repro's optimizers run in JAX's default 32-bit mode here, whatever an
    earlier test file on this worker left set."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


@contextlib.contextmanager
def _x64(on: bool):
    """JAX's 64-bit mode for one block (repro's float64 engine plan)."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(tree) -> dict:
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _j(tree) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Twins of tests/test_optim.py
# ---------------------------------------------------------------------------


def _quadratic_problem():
    """min ||W x - y||^2 over W (2-D param -> exercises the spectral path)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 64)), dtype=torch.float32)
    w_true = torch.as_tensor(rng.standard_normal((8, 8)), dtype=torch.float32)
    y = w_true @ x

    def loss(params):
        return torch.mean((params["w"] @ x - y) ** 2)

    def grad(params):
        w = params["w"].detach().requires_grad_()
        loss({"w": w}).backward()
        return {"w": w.grad}

    return loss, grad, {"w": torch.zeros((8, 8), dtype=torch.float32)}


def test_adamw_converges_on_quadratic():
    loss, grad, params = _quadratic_problem()
    opt = AdamW(lr=5e-2, weight_decay=0.0)
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(200):
        params, state, _ = opt.update(grad(params), state, params)
    assert float(loss(params)) < 1e-2 * l0


def test_adamw_grad_clip_and_m_compression():
    params = {"w": torch.ones((4, 4))}
    old = params["w"].clone()
    opt = AdamW(lr=1e-2, grad_clip=1.0)
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16  # compressed first moment
    huge = {"w": torch.full((4, 4), 1e6)}
    new_params, state, metrics = opt.update(huge, state, params)
    assert float(metrics["grad_norm"]) > 1e6
    assert torch.isfinite(new_params["w"]).all()
    # clipped step is bounded by ~lr
    assert float(torch.max(torch.abs(new_params["w"] - old))) < 0.1


def test_eigenpre_converges_and_refreshes():
    loss, grad, params = _quadratic_problem()
    opt = EigenPre(adamw=AdamW(lr=5e-2, weight_decay=0.0), rank=4,
                   refresh_every=5)
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        params, state, _ = opt.update(grad(params), state, params)
    assert float(loss(params)) < 0.1 * l0
    # eigenpairs were refreshed away from init
    assert float(torch.max(torch.abs(state.eigvecs["w"]))) > 0.0
    # gram factor is symmetric PSD-ish
    gram = state.gram["w"].double().numpy()
    np.testing.assert_allclose(gram, gram.T, atol=1e-6)
    assert np.linalg.eigvalsh(gram).min() > -1e-5


def test_eigenpre_skips_non_matrix_params():
    opt = EigenPre(max_dim=16)
    params = {"v": torch.ones((8,)), "big": torch.ones((64, 4))}
    state = opt.init(params)
    assert tuple(state.gram["v"].shape) == (1, 1)
    assert tuple(state.gram["big"].shape) == (1, 1)  # 64 > max_dim=16


def test_warmup_cosine_shape():
    s = np.array([float(warmup_cosine(torch.tensor(i), warmup=10, total=100))
                  for i in range(100)])
    assert 0.0 < s[0] <= 0.2  # step 0 trains (non-zero warmup start)
    assert abs(s[10] - 1.0) < 0.2
    assert s[99] < s[50] < s[11]


# ---------------------------------------------------------------------------
# Against repro on the same numpy inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(warmup=10, total=100),
                                dict(warmup=0, total=50, floor=0.0)])
def test_warmup_cosine_matches_repro(kw):
    """float32 arithmetic in both: within one float32 ulp of 1.0 (1.2e-7)
    at every step; the cosines may round apart by one ulp, which the
    cancellation in ``1 + cos`` near the end of the decay leaves as a few
    ulps of the (small) result."""
    steps = list(range(0, 120)) + [9_999, 10_000, 12_345]
    got = np.array([float(warmup_cosine(torch.tensor(i, dtype=torch.int32),
                                        **kw)) for i in steps], np.float32)
    ref = np.array([float(r_warmup_cosine(jnp.asarray(i, jnp.int32), **kw))
                    for i in steps], np.float32)
    assert warmup_cosine(torch.tensor(3, dtype=torch.int32)).dtype \
        == torch.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -23)


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (8, 16), "b": (16,), "stack": (3, 4, 5)}


@pytest.mark.parametrize("compress_m", [True, False])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_repro_over_steps(compress_m, clip):
    """Six steps on the same numpy gradients (clipping active at
    ``grad_clip=1``, weight decay on, a schedule scale below 1): parameters
    within 1e-6 of their scale, ``m`` (bfloat16 or float32) and ``v``
    within 1e-6 relative, the grad norm within 1e-6 relative, the count
    bitwise."""
    rng = np.random.default_rng(1)
    params = _tree(rng, SHAPES)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip,
              compress_m=compress_m)
    r_opt, p_opt = RAdamW(**kw), AdamW(**kw)
    r_params, p_params = _j(params), _t(params)
    r_state, p_state = r_opt.init(r_params), p_opt.init(p_params)
    assert p_state.count.dtype == torch.int32 and p_state.count.device.type \
        == "cpu"
    for step in range(6):
        grads = _tree(rng, SHAPES, scale=0.5)
        lr_scale = np.float32(0.5 + 0.1 * step)
        r_params, r_state, r_m = r_opt.update(_j(grads), r_state, r_params,
                                              jnp.asarray(lr_scale))
        p_params, p_state, p_m = p_opt.update(_t(grads), p_state, p_params,
                                              torch.tensor(lr_scale))
        assert int(p_state.count) == int(r_state.count) == step + 1
        np.testing.assert_allclose(float(p_m["grad_norm"]),
                                   float(r_m["grad_norm"]), rtol=1e-6)
        for k in SHAPES:
            assert p_state.m[k].dtype == (torch.bfloat16 if compress_m
                                          else torch.float32)
            np.testing.assert_allclose(_np(p_params[k]), _np(r_params[k]),
                                       rtol=0, atol=1e-6)
            for a, b in ((p_state.m[k], r_state.m[k]),
                         (p_state.v[k], r_state.v[k])):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-8)


def test_global_norm_matches_repro():
    rng = np.random.default_rng(2)
    tree = _tree(rng, SHAPES)
    from repro.optim import global_norm as r_global_norm

    np.testing.assert_allclose(float(global_norm(_t(tree))),
                               float(r_global_norm(_j(tree))), rtol=1e-6)


def _gapped_grads(rng, rows, cols, k, step):
    """``rows x cols`` gradients whose gram has a clear gap after its top
    ``k`` eigenvalues: a fixed rank-``k`` part of singular values 8..5
    plus small noise that changes with the step."""
    base = np.random.default_rng(99)
    u, _ = np.linalg.qr(base.standard_normal((rows, rows)))
    w, _ = np.linalg.qr(base.standard_normal((cols, cols)))
    s = np.zeros(min(rows, cols))
    s[:k] = np.linspace(8.0, 5.0, min(k, len(s)))
    g = (u[:, :len(s)] * s) @ w[:, :len(s)].T
    return (g + 0.05 * rng.standard_normal((rows, cols))).astype(np.float32)


def _projector(vecs) -> np.ndarray:
    """``V^T V`` over the rows of ``vecs`` (a padded row is zero)."""
    v = _np(vecs).astype(np.float64)
    return v.T @ v


def _eigh_projector(gram, rank, eps=1e-6) -> np.ndarray:
    """The float64 ``eigh`` projector on the top ``min(rank, d)``
    eigenvectors of ``gram + eps I`` (what the refresh solves)."""
    g = _np(gram).astype(np.float64)
    _, v = np.linalg.eigh(g + eps * np.eye(len(g)))
    top = v[:, -min(rank, len(g)):]
    return top @ top.T


#: EigenPre's parity tolerances by engine precision: parameters (absolute),
#: eigenvalues (relative), and the refreshed rank-k projector, against the
#: other package's (float64) or against float64 eigh (float32).  In float32
#: both packages' EEI projectors are 2e-4 to 1e-3 from float64 eigh here
#: (the float32 components, ROADMAP Queue 3), held to the engine's float32
#: component tolerance 2e-3; the parameters then drift apart by up to
#: 3.5e-4 in five steps at lr 1e-2 (held to 0.05 lr).
EIGENPRE_TOL = {"float64": dict(params=1e-6, eigvals=1e-6, proj=1e-6),
                None: dict(params=5e-4, eigvals=1e-5, proj=2e-3)}


@pytest.mark.parametrize("precision", ["float64", None])
@pytest.mark.parametrize("refresh_every", [2, 3])
def test_eigenpre_update_matches_repro_over_steps(refresh_every, precision):
    """Five steps of ``EigenPre.update`` on the same numpy gradients: a
    (12, 20) matrix (k = 4 of 12), a (2, 6) one (``k = 2 < rank = 4``: the
    padding branch), a vector and a 3-D stack (passed through).  Refreshes
    at steps 1, 3, 5 (``refresh_every=2``) or 1, 4 (3); the steps between
    reuse the eigenpairs.  With a float64 engine (``repro``'s plan with
    ``precision="float64"`` in both) the refreshed eigenpairs agree to
    float32 rounding and the whole update is held tightly; with the
    default float32 engine each package's projector is held against
    float64 eigh (``EIGENPRE_TOL``).  Grams within 1e-6 relative in both."""
    from repro.engine import SolverEngine as RSolverEngine
    from repro.engine import SolverPlan as RSolverPlan
    from repro_torch.engine import SolverEngine, SolverPlan

    tol = EIGENPRE_TOL[precision]
    rng = np.random.default_rng(3)
    shapes = {"w": (12, 20), "narrow": (2, 6), "b": (20,),
              "stack": (3, 4, 5)}
    params = _tree(rng, shapes)
    kw = dict(rank=4, refresh_every=refresh_every)
    r_kw, p_kw = dict(kw), dict(kw)
    if precision is not None:
        r_kw["engine"] = RSolverEngine(RSolverPlan(method="eei_tridiag",
                                                   precision=precision))
        p_kw["engine"] = SolverEngine(SolverPlan(method="eei_tridiag",
                                                 precision=precision),
                                      device="cpu")
    r_opt = REigenPre(adamw=RAdamW(lr=1e-2, weight_decay=0.0), **r_kw)
    p_opt = EigenPre(adamw=AdamW(lr=1e-2, weight_decay=0.0), **p_kw)
    r_params, p_params = _j(params), _t(params)
    r_state, p_state = r_opt.init(r_params), p_opt.init(p_params)
    for k in shapes:
        assert tuple(p_state.gram[k].shape) == tuple(r_state.gram[k].shape)
        assert tuple(p_state.eigvecs[k].shape) == tuple(
            r_state.eigvecs[k].shape)
    refreshed = []
    for step in range(1, 6):
        grads = {"w": _gapped_grads(rng, 12, 20, 4, step),
                 "narrow": _gapped_grads(rng, 2, 6, 2, step),
                 "b": rng.standard_normal(20).astype(np.float32),
                 "stack": rng.standard_normal((3, 4, 5)).astype(np.float32)}
        before = p_state.eigvecs["w"].clone()
        with _x64(precision == "float64"):
            r_params, r_state, _ = r_opt.update(_j(grads), r_state,
                                                r_params)
        p_params, p_state, _ = p_opt.update(_t(grads), p_state, p_params)
        refresh = not torch.equal(before, p_state.eigvecs["w"])
        refreshed.append(refresh)
        for k in shapes:
            np.testing.assert_allclose(_np(p_params[k]), _np(r_params[k]),
                                       rtol=0, atol=tol["params"], err_msg=k)
        for k in ("w", "narrow"):
            assert p_state.eigvals[k].dtype == torch.float32
            np.testing.assert_allclose(_np(p_state.gram[k]),
                                       _np(r_state.gram[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(_np(p_state.eigvals[k]),
                                       _np(r_state.eigvals[k]),
                                       rtol=tol["eigvals"])
            if not refresh:
                continue
            got = _projector(p_state.eigvecs[k])
            if precision is not None:
                np.testing.assert_allclose(
                    got, _projector(r_state.eigvecs[k]), atol=tol["proj"],
                    err_msg=k)
            else:
                exact = _eigh_projector(p_state.gram[k], 4)
                for proj in (got, _projector(r_state.eigvecs[k])):
                    np.testing.assert_allclose(proj, exact,
                                               atol=tol["proj"], err_msg=k)
    assert refreshed == [(s % refresh_every) == 1 for s in range(1, 6)]
    # The padding branch: rank - k leading eigenvalues of 1, zero vectors.
    np.testing.assert_array_equal(_np(p_state.eigvals["narrow"])[:2], 1.0)
    np.testing.assert_array_equal(_np(p_state.eigvecs["narrow"])[:2], 0.0)
    assert tuple(p_state.gram["b"].shape) == (1, 1)


def test_eigenpre_with_refresh_every_one_never_refreshes_as_in_repro():
    """``(count + 1) % 1 == 1`` never holds: both packages keep the initial
    eigenpairs and the preconditioner is the identity."""
    rng = np.random.default_rng(4)
    params = _tree(rng, {"w": (6, 10)})
    r_opt = REigenPre(adamw=RAdamW(), refresh_every=1)
    p_opt = EigenPre(adamw=AdamW(), refresh_every=1)
    r_state, p_state = r_opt.init(_j(params)), p_opt.init(_t(params))
    r_params, p_params = _j(params), _t(params)
    for _ in range(3):
        grads = _tree(rng, {"w": (6, 10)})
        r_params, r_state, _ = r_opt.update(_j(grads), r_state, r_params)
        p_params, p_state, _ = p_opt.update(_t(grads), p_state, p_params)
    assert not np.asarray(r_state.eigvecs["w"]).any()
    assert not p_state.eigvecs["w"].any()
    np.testing.assert_allclose(_np(p_params["w"]), _np(r_params["w"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3",
                                  "codeqwen1.5-7b"])
def test_eigenpre_eligibility_on_the_full_width_tables(arch):
    """On repro's stacked full-width tables the port's EigenPre makes
    repro's decisions: the stacked norm scales are eligible (gemma2-2b:
    four of (13, 2304)), nothing 3-D is, and the grams and eigenvector
    shapes of ``init`` are repro's (``meta`` tensors, no allocation)."""
    table = param_table(p_registry.get_config(arch))
    params = {k: torch.empty(d.shape, device="meta")
              for k, d in table.items()}
    r_model = RLanguageModel(r_registry.get_config(arch))
    r_abstract = r_model.abstract()
    opt, r_opt = EigenPre(), REigenPre()
    ours = {k for k, p in params.items() if opt._eligible(p)}
    ref = {k for k, p in r_abstract.items() if r_opt._eligible(p)}
    assert ours == ref
    assert not any(len(table[k].shape) == 3 for k in ours)
    if arch == "gemma2-2b":
        assert {k: table[k].shape for k in ours} == {
            f"dec/g0/{b}/{ln}": (13, 2304)
            for b in ("b0:attn_local", "b1:attn") for ln in ("ln1", "ln2")}
    state = opt.init(params)
    r_state = jax.eval_shape(r_opt.init, r_abstract)
    for k in params:
        assert tuple(state.gram[k].shape) == tuple(r_state.gram[k].shape), k
        assert tuple(state.eigvecs[k].shape) == tuple(
            r_state.eigvecs[k].shape), k


def test_refresh_of_a_gram_far_below_scale_one_loses_its_signs_in_both_packages():
    """A property of repro, not a fault of the port: EigenPre's grams are
    far below scale 1 (gemma2-2b's at full width: spectral norms 6e-10 to
    3e-6 on the card), where ``tridiagonal_signs`` takes every
    off-diagonal under ``eps * max(scale, 1)`` as zero and gives it sign
    +1.  On such a 13 x 13 gram both packages' float32 top-4 vectors are
    far from eigh's (projector off by > 0.5), and within 4e-3 of each
    other (measured 4.6e-4); the same gram scaled by 2**20 is solved
    within 2e-3 in both (the engine's float32 component tolerance), so the
    two projectors stay within twice that of each other."""
    from repro.engine import SolverEngine as RSolverEngine
    from repro.engine import SolverPlan as RSolverPlan
    from repro_torch.engine import SolverEngine, SolverPlan

    rng = np.random.default_rng(0)
    g = (rng.standard_normal((13, 2304)) * 3e-3).astype(np.float32)
    gram = (0.05 * (g @ g.T / 2304) + 1e-6 * np.eye(13)).astype(np.float32)
    _, v = np.linalg.eigh(gram.astype(np.float64))
    exact = v[:, -4:] @ v[:, -4:].T
    r_engine = RSolverEngine(RSolverPlan(method="eei_tridiag"))
    p_engine = SolverEngine(SolverPlan(method="eei_tridiag"), device="cpu")
    for scale, far in ((1.0, True), (2.0 ** 20, False)):
        a = gram * np.float32(scale)
        ref = _projector(r_engine.topk(jnp.asarray(a), 4).vectors)
        got = _projector(p_engine.topk(torch.as_tensor(a), 4).vectors)
        np.testing.assert_allclose(got, ref, atol=4e-3)
        for proj in (got, ref):
            err = np.abs(proj - exact).max()
            assert (err > 0.5) if far else (err <= 2e-3), (scale, err)
