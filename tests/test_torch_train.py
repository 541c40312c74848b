"""The port's trainer against repro's, on the CPU.

``make_train_step`` (``TrainState`` in repro's stacked layout, AdamW or
EigenPre, float32 compute) is held against repro's jitted step at reduced
width for codeqwen1.5-7b (untied head), gemma2-2b (tied embedding,
softcaps, local window) and whisper-large-v3 (frames, ``enc_pos``), from
repro's own initial state carried across by
``interop.train_state_from_reference``: the gradients of step 1, then the
loss and grad-norm trajectories over five steps.  Then remat and
microbatching, the twins of ``tests/test_distribution.py``'s checkpoint,
supervisor, data and microbatch tests (gemma2-2b where repro's use
xlstm-125m), checkpoints
across the two packages, and ``launch/train.py`` in a subprocess.

Tolerances (from ``python tests/test_torch_train.py``, which prints the
measured errors; stated where used): step-1 gradients 3e-4 of each
leaf's max |g| (``tests/test_torch_lm.py``'s float32 model tolerance;
measured at most 1.7e-5 for codeqwen and gemma, 2.2e-4 for whisper,
whose reduced attention is sharp: there the port's float32 gradients are
up to 1.8e-4 and repro's up to 1.0e-4 of max |g| from a float64 run); the
loss 1e-5 relative at step 1 (``tests/test_torch_lm.py``'s float32 loss
tolerance; measured 3.0e-7) and 1e-4 over five steps (measured 4.1e-5);
the grad norm 5e-3 relative (measured 1.4e-5 but for whisper, 1.1e-3
with AdamW and 2.8e-3 with EigenPre: Adam's first steps move each weight
by about ``lr * sign(g)``, so weights whose gradient is rounding noise
step apart, and EigenPre's float32 EEI projectors differ by up to ~1e-3,
``tests/test_torch_optim.py``); microbatched gradients at repro's
``rtol 2e-4, atol 2e-5``; remat bitwise.

EigenPre runs with ``max_dim=256`` in the step tests: the reduced
models' 512-row embedding is eligible under the default 1024, and its
512 x 512 refresh takes ~6.5 s of plain versions on a CPU (a 64-row
gram ~0.16 s); the stacked norm scales ``(2, 64)`` (``k = 2 < rank``, the
padding branch), the untied heads ``(64, 512)`` and whisper's ``enc_pos``
stay eligible.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RCheckpointManager
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import reduced_config as r_reduced_config
from repro.data import make_synthetic as r_make_synthetic
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.models.lm import LanguageModel as RLanguageModel
from repro.optim import AdamW as RAdamW
from repro.optim import EigenPre as REigenPre
from repro.train import TrainState as RTrainState
from repro.train import make_train_step as r_make_train_step
from repro.train.steps import cast_tree as r_cast_tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import PrefetchIterator, make_synthetic
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.interop import train_state_from_reference
from repro_torch.models import blocks
from repro_torch.models.lm import LanguageModel
from repro_torch.optim import AdamW, EigenPre
from repro_torch.optim.eigenpre import EigenPreState
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import TrainState, make_train_step, put_batch
from repro_torch.train.microbatch import accumulated_grads

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("codeqwen1.5-7b", "gemma2-2b", "whisper-large-v3")
#: Sequence, batch and steps of the parity runs (tests/test_system.py's).
SEQ, BATCH, STEPS = 16, 4, 5
LR = 3e-3
GRAD_TOL, LOSS_TOL_1, LOSS_TOL, GNORM_TOL = 3e-4, 1e-5, 1e-4, 5e-3
#: EigenPre's gram bound in the step tests (see the module docstring).
MAX_DIM = 256


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    """repro's trainer runs in JAX's default 32-bit mode here, whatever an
    earlier test file on this worker left set."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _optimizers(kind: str):
    kw = dict(lr=LR, weight_decay=0.0)
    if kind == "adamw":
        return RAdamW(**kw), AdamW(**kw)
    ep = dict(rank=4, refresh_every=2, max_dim=MAX_DIM)
    return (REigenPre(adamw=RAdamW(**kw), **ep),
            EigenPre(adamw=AdamW(**kw), **ep))


def _setup(arch: str, kind: str, seed: int = 0):
    """Both packages' model, optimizer, initial state (repro's, carried
    across) and data source."""
    r_cfg = r_reduced_config(r_get_config(arch))
    r_model = RLanguageModel(r_cfg)
    r_params = r_model.init(jax.random.PRNGKey(seed))
    r_opt, p_opt = _optimizers(kind)
    r_state = RTrainState(r_params, r_opt.init(r_params),
                          jnp.zeros((), jnp.int32))
    state = train_state_from_reference(_numpy_tree(r_state), "cpu")
    model = LanguageModel(reduced_config(get_config(arch)), device="cpu")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    source = make_synthetic(model.cfg, shape, seed=seed)
    return r_model, r_opt, r_state, model, p_opt, state, source


def _r_grads(r_model, params, batch):
    def loss_fn(p):
        return r_model.loss(r_cast_tree(p, jnp.float32), batch)

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return float(loss), grads


def _p_grads(model, params, batch, n_micro=1):
    def loss_fn(p, b):
        return model.loss(model.unstack(p), b)

    loss, _, grads = accumulated_grads(loss_fn, params, batch, n_micro)
    return float(loss), grads


def measure(arch: str, kind: str):
    """The step-1 gradient error (max over leaves of |port - repro| / max
    |repro|) and the per-step relative loss and grad-norm errors."""
    r_model, r_opt, r_state, model, p_opt, state, source = _setup(arch, kind)
    batch0 = source.global_batch_at(0)
    r_loss, r_g = _r_grads(r_model, r_state.params,
                           {k: jnp.asarray(v) for k, v in batch0.items()})
    p_loss, p_g = _p_grads(model, state.params, put_batch(batch0, "cpu"))
    grad_err = {k: float(np.abs(p_g[k].numpy() - np.asarray(r_g[k])).max()
                         / max(float(np.abs(np.asarray(r_g[k])).max()),
                               1e-30))
                for k in r_g}
    r_step = jax.jit(r_make_train_step(r_model, r_opt,
                                       compute_dtype=jnp.float32))
    p_step = make_train_step(model, p_opt, compute_dtype=torch.float32)
    losses, gnorms = [], []
    for i in range(STEPS):
        batch = source.global_batch_at(i % 4)
        r_state, r_m = r_step(r_state,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        state, p_m = p_step(state, put_batch(batch, "cpu"))
        losses.append((float(p_m["loss"]), float(r_m["loss"])))
        gnorms.append((float(p_m["grad_norm"]), float(r_m["grad_norm"])))
    assert int(state.step) == STEPS and state.step.device.type == "cpu"
    return dict(loss1=(p_loss, r_loss), grad_err=grad_err, losses=losses,
                gnorms=gnorms, state=state)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("kind", ["adamw", "eigenpre"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro(arch, kind):
    m = measure(arch, kind)
    p_loss, r_loss = m["loss1"]
    assert _rel(p_loss, r_loss) <= LOSS_TOL_1, m["loss1"]
    worst = max(m["grad_err"], key=m["grad_err"].get)
    assert m["grad_err"][worst] <= GRAD_TOL, (worst, m["grad_err"][worst])
    for i, ((pl, rl), (pg, rg)) in enumerate(zip(m["losses"], m["gnorms"])):
        assert np.isfinite(pl) and _rel(pl, rl) <= LOSS_TOL, (i, pl, rl)
        assert _rel(pg, rg) <= GNORM_TOL, (i, pg, rg)
    if kind == "eigenpre":
        opt_state = m["state"].opt_state
        assert isinstance(opt_state, EigenPreState)
        # The stacked norm scales are eligible and were refreshed (k = 2
        # of rank 4: two padded rows of zeros, two unit vectors).
        ln = [k for k in opt_state.gram if k.endswith("/ln1")]
        assert ln and all(tuple(opt_state.gram[k].shape) == (2, 2)
                          for k in ln)
        for k in ln:
            vec = opt_state.eigvecs[k]
            assert not vec[:2].any()
            torch.testing.assert_close(vec[2:] @ vec[2:].T, torch.eye(2),
                                       rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Remat and microbatching
# ---------------------------------------------------------------------------


def _gemma(remat=False, policy="all"):
    cfg = reduced_config(get_config("gemma2-2b")).scaled(
        remat=remat, remat_policy=policy)
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    batch = put_batch(make_synthetic(cfg, ShapeConfig("t", SEQ, BATCH,
                                                      "train"),
                                     seed=3).global_batch_at(0), "cpu")
    return model, batch


@pytest.mark.parametrize("policy", ["all", "dots", "none"])
def test_remat_recomputes_each_layer_and_gives_the_same_gradients(
        policy, monkeypatch):
    """With ``cfg.remat`` each layer's blocks run twice (forward, then the
    recompute in backward) under every policy, once without it; the loss
    and every gradient are bitwise the run without remat."""
    calls = {"n": 0}
    apply_block = blocks.apply_block

    def counting(*args, **kwargs):
        calls["n"] += 1
        return apply_block(*args, **kwargs)

    monkeypatch.setattr(blocks, "apply_block", counting)
    runs = {}
    for remat in (False, True):
        model, batch = _gemma(remat, policy)
        calls["n"] = 0
        runs[remat] = _p_grads(model, model.stacked_dict(), batch)
        n_blocks = sum(r * len(kinds) for r, kinds in model.cfg.pattern)
        assert calls["n"] == (2 if remat else 1) * n_blocks, (remat, calls)
    assert runs[True][0] == runs[False][0]
    for k, g in runs[False][1].items():
        assert torch.equal(runs[True][1][k], g), k


def test_remat_runs_only_for_the_loss_under_grad(monkeypatch):
    """No checkpointing without grad or in prefill (it wants each layer's
    cache payload); one checkpointed call a layer for the loss under
    grad."""
    from repro_torch.models import lm

    calls = []
    checkpoint = lm._checkpoint

    def counting(*args):
        calls.append(args[0])
        return checkpoint(*args)

    monkeypatch.setattr(lm, "_checkpoint", counting)
    model, batch = _gemma(True, "dots")
    params = model.param_dict()
    with torch.no_grad():
        model.loss(params, batch)
    model.prefill(params, batch, SEQ + 4)
    assert not calls
    model.loss(params, batch)
    assert calls == ["dots"] * sum(r for r, _ in model.cfg.pattern)


def test_microbatched_train_step_gives_the_full_batch_gradients():
    """``make_train_step(microbatch=2)`` under remat: the gradients of the
    full batch at repro's rtol 2e-4, atol 2e-5 (tests/test_distribution.py
    :209), and the mean loss at rtol 1e-5."""
    model, batch = _gemma(True, "dots")
    full_loss, full = _p_grads(model, model.stacked_dict(), batch)
    mb_loss, mb = _p_grads(model, model.stacked_dict(), batch, 2)
    np.testing.assert_allclose(mb_loss, full_loss, rtol=1e-5)
    for k in full:
        np.testing.assert_allclose(mb[k].numpy(), full[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    # Through the step: the same update as a full-batch step.
    states = []
    for micro in (None, 2):
        params = {k: v.clone() for k, v in model.stacked_dict().items()}
        opt = AdamW(lr=LR)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32))
        step = make_train_step(model, opt, torch.float32, microbatch=micro)
        states.append(step(state, batch))
    (s_full, m_full), (s_mb, m_mb) = states
    np.testing.assert_allclose(float(m_mb["loss"]), float(m_full["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_mb["grad_norm"]),
                               float(m_full["grad_norm"]), rtol=2e-4)


# ---------------------------------------------------------------------------
# Twins of tests/test_distribution.py
# ---------------------------------------------------------------------------


def _small_state(arch, optimizer):
    model = LanguageModel(reduced_config(get_config(arch)), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    params = model.stacked_dict()
    return model, TrainState(params, optimizer.init(params),
                             torch.zeros((), dtype=torch.int32))


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten

    return _flatten(tree)


def test_checkpoint_roundtrip_and_gc():
    _, state = _small_state("gemma2-2b", AdamW())
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, state, extra={"data_step": step}, blocking=True)
        assert mgr.steps() == [2, 3]  # keep-2 GC
        restored, extra = mgr.restore(state)
        assert extra["data_step"] == 3
        a, b = _leaves(state), _leaves(restored)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].device == b[k].device
            assert torch.equal(a[k], b[k]), k
        assert restored.opt_state.m["embed/tokens"].dtype == torch.bfloat16


def test_checkpoint_async_save_is_a_snapshot():
    """``save`` copies to the host before it returns: an in-place update
    right after it does not reach the files."""
    _, state = _small_state("codeqwen1.5-7b", AdamW())
    before = state.params["final_norm"].clone()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(7, state)
        state.params["final_norm"].add_(1.0)
        mgr.wait()
        restored, _ = mgr.restore(state)
    assert torch.equal(restored.params["final_norm"], before)


def _supervised(inject_at: int, n_steps: int):
    model, state = _small_state("codeqwen1.5-7b", AdamW(lr=1e-3))
    step_fn_inner = make_train_step(model, AdamW(lr=1e-3),
                                    compute_dtype=torch.float32)
    source = make_synthetic(model.cfg, ShapeConfig("t", 16, 2, "train"))
    data = PrefetchIterator(source)
    boom = {"armed": True}
    seen = []  # (step, batch fingerprint) for every successful step

    def step_fn(state, batch):
        s = int(state.step)
        if s == inject_at and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")
        seen.append((s, int(np.asarray(batch["tokens"]).sum())))
        return step_fn_inner(state, put_batch(batch, "cpu"))

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(CheckpointManager(d),
                         SupervisorConfig(checkpoint_every=2))
        final = sup.run(state, data, step_fn, n_steps=n_steps)
    data.close()
    return final, boom, seen, source


def test_supervisor_recovers_from_transient_failure():
    final, boom, _, _ = _supervised(3, 6)
    assert int(final.step) == 6
    assert not boom["armed"], "failure was injected and survived"


def test_supervisor_rolls_back_before_first_periodic_checkpoint():
    """The step-0 seed checkpoint makes a retry before the first periodic
    checkpoint an exact replay: the last execution of step s consumed
    batch s."""
    final, boom, seen, source = _supervised(1, 4)
    assert int(final.step) == 4
    assert not boom["armed"], "failure was injected and survived"
    expected = [int(source.shard_at(s, 0, 1)["tokens"].sum())
                for s in range(4)]
    assert dict(seen) == {s: expected[s] for s in range(4)}


def test_supervisor_quarantines_a_non_finite_loss():
    """A NaN loss rolls back to the last checkpoint and skips one data
    window: the step after the rollback consumes the next batch."""
    model, state = _small_state("codeqwen1.5-7b", AdamW(lr=1e-3))
    inner = make_train_step(model, AdamW(lr=1e-3), torch.float32)
    source = make_synthetic(model.cfg, ShapeConfig("t", 16, 2, "train"))
    data = PrefetchIterator(source)
    poisoned, seen = {"armed": True}, []

    def step_fn(state, batch):
        s = int(state.step)
        seen.append((s, int(np.asarray(batch["tokens"]).sum())))
        state, metrics = inner(state, put_batch(batch, "cpu"))
        if s == 1 and poisoned["armed"]:
            poisoned["armed"] = False
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return state, metrics

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(CheckpointManager(d),
                         SupervisorConfig(checkpoint_every=2))
        final = sup.run(state, data, step_fn, n_steps=3)
    data.close()
    assert int(final.step) == 3
    tokens = [int(source.shard_at(s, 0, 1)["tokens"].sum()) for s in range(4)]
    # step 0 (batch 0), step 1 (batch 1, NaN), rollback to the step-0
    # checkpoint, skip one window: step 0 takes batch 1, then 2, 3.
    assert seen == [(0, tokens[0]), (1, tokens[1]), (0, tokens[1]),
                    (1, tokens[2]), (2, tokens[3])]


def test_data_pipeline_determinism_and_sharding_matches_repro():
    src = SyntheticLM(vocab_size=100, seq_len=8, global_batch=4, seed=1)
    b0 = src.global_batch_at(3)
    b1 = src.global_batch_at(3)
    np.testing.assert_array_equal(b0["tokens"], b1["tokens"])
    # host shards partition the global batch rows
    s0 = src.shard_at(3, 0, 2)
    s1 = src.shard_at(3, 1, 2)
    np.testing.assert_array_equal(
        np.sort(np.concatenate([s0["tokens"], s1["tokens"]]), axis=0),
        np.sort(b0["tokens"], axis=0))
    # labels are next-token shifted
    full = np.concatenate([b0["tokens"][:, :1], b0["labels"]], axis=1)
    np.testing.assert_array_equal(b0["tokens"][:, 1:], full[:, 1:-1])
    # bitwise repro's batches, frames included
    ref = RSyntheticLM(vocab_size=100, seq_len=8, global_batch=4, seed=1)
    for step in (0, 3):
        for a, b in ((src.shard_at(step, 1, 2), ref.shard_at(step, 1, 2)),):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    cfg = reduced_config(get_config("whisper-large-v3"))
    shape = ShapeConfig("t", 8, 2, "train")
    got = make_synthetic(cfg, shape, seed=5).global_batch_at(2)
    want = r_make_synthetic(r_reduced_config(r_get_config(
        "whisper-large-v3")), RShapeConfig("t", 8, 2, "train"),
        seed=5).global_batch_at(2)
    assert got.keys() == want.keys() == {"tokens", "labels", "frames"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_iterator_resume():
    src = SyntheticLM(vocab_size=50, seq_len=4, global_batch=2, seed=0)
    it = PrefetchIterator(src, start_step=0)
    a = next(it)
    b = next(it)
    assert it.state() == {"step": 2}
    it.close()
    it2 = PrefetchIterator(src, start_step=1)
    b2 = next(it2)
    it2.close()
    np.testing.assert_array_equal(b["tokens"], b2["tokens"])
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_microbatch_grads_match_full_batch():
    model = LanguageModel(reduced_config(get_config("codeqwen1.5-7b")),
                          device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, model.cfg.vocab_size, (4, 8),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    l_full, g_full = _p_grads(model, model.stacked_dict(), batch)
    l_mb, g_mb = _p_grads(model, model.stacked_dict(), batch, 2)
    np.testing.assert_allclose(l_full, l_mb, rtol=1e-5)
    for k in g_full:
        np.testing.assert_allclose(g_full[k].numpy(), g_mb[k].numpy(),
                                   rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoints_restore_across_the_packages(writer):
    """An EigenPre train state (nested named tuples, bfloat16 ``m``) that
    one package's manager writes restores bitwise into the other's."""
    r_cfg = r_reduced_config(r_get_config("gemma2-2b"))
    r_params = RLanguageModel(r_cfg).init(jax.random.PRNGKey(0))
    r_opt = REigenPre()
    r_state = RTrainState(r_params, r_opt.init(r_params),
                          jnp.asarray(7, jnp.int32))
    # Move the moments off zero so that the comparison sees values.
    r_state = r_state._replace(opt_state=r_state.opt_state._replace(
        adamw=r_state.opt_state.adamw._replace(
            count=jnp.asarray(7, jnp.int32),
            m=jax.tree.map(lambda p: (p * 0.5).astype(jnp.bfloat16),
                           r_params),
            v=jax.tree.map(lambda p: p * p, r_params))))
    state = train_state_from_reference(_numpy_tree(r_state), "cpu")
    with tempfile.TemporaryDirectory() as d:
        if writer == "repro":
            RCheckpointManager(d).save(7, r_state, extra={"data_step": 7},
                                       blocking=True)
            like = train_state_from_reference(_numpy_tree(jax.tree.map(
                jnp.zeros_like, r_state)), "cpu")
            got, extra = CheckpointManager(d).restore(like)
            want = state
        else:
            CheckpointManager(d).save(7, state, extra={"data_step": 7},
                                      blocking=True)
            restored, extra = RCheckpointManager(d).restore(
                jax.tree.map(jnp.zeros_like, r_state))
            got = train_state_from_reference(_numpy_tree(restored), "cpu")
            want = state
    assert extra == {"data_step": 7}
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys() and "a:opt_state§a:adamw§a:m§k:embed/tokens" \
        in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_train_state_from_reference_is_bitwise():
    r_cfg = r_reduced_config(r_get_config("codeqwen1.5-7b"))
    r_params = RLanguageModel(r_cfg).init(jax.random.PRNGKey(1))
    r_state = RTrainState(r_params, RAdamW().init(r_params),
                          jnp.asarray(3, jnp.int32))
    state = train_state_from_reference(_numpy_tree(r_state), "cpu")
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    assert state.opt_state.m["unembed"].dtype == torch.bfloat16
    for k, v in r_params.items():
        assert torch.equal(state.params[k], torch.as_tensor(np.array(v)))
    model = LanguageModel(reduced_config(get_config("codeqwen1.5-7b")),
                          device="cpu")
    assert set(state.params) == set(model.stacked_dict())


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _launch(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_trains_checkpoints_and_resumes_on_the_cpu():
    """4 steps with a checkpoint every 2, then ``--resume`` to 6: exit 0
    both times, the second run resumes at step 4's checkpoint and trains
    steps 4 and 5.  (AdamW: ``--eigenpre`` refreshes the reduced model's
    512-row embedding gram, ~6.5 s of plain versions on a CPU; the card
    runs the launcher with ``--eigenpre`` in ``chip_smoke.py`` phase 15.)"""
    with tempfile.TemporaryDirectory() as d:
        common = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                  "--ckpt-every", "2", "--ckpt-dir", d, "--log-every", "1"]
        first = _launch(common + ["--steps", "4"])
        assert first.returncode == 0, first.stderr[-3000:]
        assert "on cpu" in first.stderr and "AdamW" in first.stderr
        assert sorted(os.listdir(Path(d) / "gemma2-2b-smoke")) == [
            "step-0", "step-2", "step-4"]
        second = _launch(common + ["--steps", "6", "--resume"])
        assert second.returncode == 0, second.stderr[-3000:]
        assert "resumed at step 4" in second.stderr
        assert "step     4 loss" in second.stderr
        assert "step     5 loss" in second.stderr
        assert "step     3 loss" not in second.stderr


def test_launcher_refuses_without_a_card_and_on_a_mesh(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(["--arch", "gemma2-2b", "--reduced", "--mesh", "2x2x1",
                    "--device", "cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanguageModel(reduced_config(get_config("gemma2-2b")))


def test_launcher_trains_reduced_xlstm():
    """xlstm-125m, once refused by block kind, trains: one reduced step
    (its sLSTM's time loop under autograd) with a checkpoint."""
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as d:
        train.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                    "--steps", "1", "--seq", "16", "--batch", "2",
                    "--ckpt-every", "1", "--ckpt-dir", d])
        assert sorted(os.listdir(Path(d) / "xlstm-125m-smoke")) == [
            "step-0", "step-1"]


if __name__ == "__main__":
    for arch in ARCHS:
        for kind in ("adamw", "eigenpre"):
            m = measure(arch, kind)
            worst = max(m["grad_err"], key=m["grad_err"].get)
            print(f"{arch} {kind}: loss1 {_rel(*m['loss1']):.2e}, grads "
                  f"{m['grad_err'][worst]:.2e} ({worst}), losses "
                  f"{max(_rel(*x) for x in m['losses']):.2e}, grad norms "
                  f"{max(_rel(*x) for x in m['gnorms']):.2e}")
