"""The sharded language model on logical CPU meshes, against the port's
unsharded path and against repro's programs.

A mesh of ``devices=["cpu"] * D*M`` runs ``train.steps.build_programs``:
parameters, optimizer state and caches held as shards by repro's specs,
each data row running its slice of the batch with the model axis split
inside it (``models.lm.MeshLM``).  GSPMD computes the function of the
unsharded program, so each mesh is held to the port's 1x1 path (itself
held to repro by ``tests/test_torch_lm.py``, ``test_torch_moe_mla.py``,
``test_torch_ssm.py`` and ``test_torch_train.py``) in float32, for reduced
gemma2-2b (heads split on 1x2, the query sequence on 1x3), deepseek-v3-671b
(MLA, the MoE's experts over the model axis), zamba2-2.7b (Mamba2's
``inner`` gathered, the shared attention) and whisper-large-v3 (the
encoder, ``dec_cross``), on 1x2, 2x1, 1x3 and 2x2:

* prefill logits and four decode steps within 1e-5 of max |logit|
  (``LOGIT_TOL``; measured at most 5.3e-6).  Reduced whisper is the
  exception: its sharp reduced attention puts the 1x1 path's own float32
  logits 4e-6 to 1.5e-5 of max |logit| from a float64 run, and the mesh's,
  whose sums run in another order, 8e-6 to 5.0e-5 (1x2), so its float32
  gate is ``tests/test_torch_lm.py``'s float32 model tolerance, 3e-4
  (measured 3.7e-5).  Every config is also run with float64 weights
  (the attention's scores stay float32, as repro's
  ``preferred_element_type``), where whisper too holds within 1e-5
  (measured at most 2.7e-6, on 1x3, whose query slices change the score
  products' shapes; 0 on the other meshes).  ``python
  tests/test_torch_sharded_lm.py`` prints the errors;
* on 1x1, in bfloat16 and float32, the same logits bit for bit;
* one AdamW and one EigenPre step (the first refreshes, so the EEI engine
  runs on the gathered grams): the loss within 1e-6 relative, the
  parameters within 1e-5 relative L2 (measured at most 7e-8 and 1.1e-7).

Against repro directly: reduced gemma2-2b on 1x3 (prefill, ``serve_step``
and an AdamW ``train_step``), and reduced deepseek-v3-671b on 2x1 with a
MoE routing group that straddles the two rows, where per-row groups would
change the capacity and the dropped tokens.  Then resharding a checkpoint
between meshes, ``restore(shardings=)``, ``Supervisor.run(
state_shardings=)`` and both launchers with ``--mesh``.

EigenPre runs with ``max_dim=32`` (the reduced models' eligible keys are
then the stacked norm scales, as at full width, ``tests/test_torch_
train.py``'s reason).
"""

from __future__ import annotations

import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import reduced_config as r_reduced_config
from repro.models.lm import LanguageModel as RLanguageModel
from repro.optim import AdamW as RAdamW
from repro.train import TrainState as RTrainState
from repro.train import make_serve_step as r_make_serve_step
from repro.train import make_train_step as r_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import PrefetchIterator, make_synthetic
from repro_torch.interop import params_from_reference, train_state_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import LanguageModel, moe
from repro_torch.optim import AdamW, EigenPre
from repro_torch.runtime import Supervisor, SupervisorConfig, reshard_state
from repro_torch.sharding import placement
from repro_torch.sharding.placement import Sharded
from repro_torch.train import TrainState, make_train_step, put_batch
from repro_torch.train import steps

ARCHS = ("gemma2-2b", "deepseek-v3-671b", "zamba2-2.7b", "whisper-large-v3")
MESHES = ("1x2", "2x1", "1x3", "2x2")
B, S, GEN = 2, 8, 4
LOGIT_TOL = 1e-5
LOSS_TOL, PARAM_TOL = 1e-6, 1e-5
#: test_torch_lm.py's float32 model tolerance and test_torch_train.py's
#: step-1 loss and grad-norm tolerances, for the checks against repro.
R_MODEL_TOL, R_LOSS_TOL, R_GNORM_TOL = 3e-4, 1e-5, 5e-3
#: The sharp reduced config's float32 logit bound (the module docstring).
SHARP = {"whisper-large-v3": R_MODEL_TOL}
LR = 3e-3
#: XLA's CPU backend without its optimization passes for repro's programs
#: (``tests/test_torch_ssm.py``'s): compiling them is most of the cost.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_float32_jax():
    """The port's side on one thread (tiny tensors; parallel workers would
    otherwise each start a thread a core), and repro in JAX's default
    32-bit mode whatever an earlier test file on this worker left set."""
    was_threads, was_x64 = torch.get_num_threads(), jax.config.jax_enable_x64
    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", False)
    yield
    torch.set_num_threads(was_threads)
    jax.config.update("jax_enable_x64", was_x64)


def _mesh(spec: str):
    d, m = (int(p) for p in spec.split("x"))
    return make_local_mesh(d, m, devices=["cpu"] * (d * m))


def _model(arch: str, dtype=torch.float32) -> LanguageModel:
    return LanguageModel(reduced_config(get_config(arch)), device="cpu",
                         dtype=dtype).init(torch.Generator().manual_seed(0))


def _batch(cfg, b=B, s=S, dtype=torch.float32) -> dict:
    out = serve_cli.lm_batch(cfg, b, s, 0, "cpu")
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in out.items()}


def _serve_1x1(model, batch, dtype=torch.float32):
    """The unsharded path's prefill and greedy decode logits (float32)."""
    params = steps.cast_tree(model.param_dict(), dtype)
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, S + GEN)
        out, toks = [logits.float()], []
        for i in range(GEN):
            toks.append(torch.argmax(out[-1], dim=-1))
            logits, caches = model.decode_step(params, caches, toks[-1], S + i)
            out.append(logits.float())
    return out, toks


_SERVED: dict = {}


def _served(arch, dtype=torch.float32):
    """The 1x1 model, prompts, logits and greedy tokens, and the bound."""
    if (arch, dtype) not in _SERVED:
        model = _model(arch, dtype)
        batch = _batch(model.cfg, dtype=dtype)
        ref, toks = _serve_1x1(model, batch, dtype)
        bound = (LOGIT_TOL if dtype == torch.float64
                 else SHARP.get(arch, LOGIT_TOL))
        _SERVED[arch, dtype] = (model, batch, ref, toks, bound)
    return _SERVED[arch, dtype]


def _rel_max(got, ref) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def mesh_serving_errors(arch: str, spec: str, dtype=torch.float32):
    """The mesh's prefill and decode logits' distances from 1x1 (relative
    to max |logit|), and the bound."""
    model, batch, ref, toks, bound = _served(arch, dtype)
    mesh = _mesh(spec)
    progs = steps.build_programs(model, mesh, compute_dtype=dtype)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    logits, caches = progs.prefill(params, batch, S + GEN)
    got = [logits]
    for i, t in enumerate(toks):
        logits, caches = progs.decode_step(params, caches, t, S + i)
        got.append(logits)
    return [_rel_max(g, r) for g, r in zip(got, ref)], bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_equals_the_unsharded_path(arch, spec, dtype):
    errs, bound = mesh_serving_errors(arch, spec, dtype)
    for step, err in enumerate(errs):
        assert err <= bound, (arch, spec, step, err, bound)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_1x1_mesh_serves_the_unsharded_path_bitwise(arch, dtype):
    """A row of one device runs the unsharded blocks on its shards, so a
    1x1 mesh gives the unsharded path's logits bit for bit."""
    errs, _ = mesh_serving_errors(arch, "1x1", dtype)
    assert errs == [0.0] * (GEN + 1), errs


def test_serve_step_takes_the_unsharded_path_s_tokens():
    """``serve_step`` (greedy, under the programs' hints) on 1x3 gives the
    tokens of the 1x1 loop, and its caches are shards on the mesh."""
    model, batch, ref, toks, _ = _served("gemma2-2b")
    mesh = _mesh("1x3")
    progs = steps.build_programs(model, mesh, compute_dtype=torch.float32)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    logits, caches = progs.prefill(params, batch, S + GEN)
    tok = torch.argmax(logits, dim=-1)
    for i in range(GEN - 1):
        assert torch.equal(tok, toks[i])
        tok, caches = progs.serve_step(params, caches, tok, S + i)
    assert torch.equal(tok, toks[GEN - 1])
    leaf = caches[0]["b0:attn_local"]["k"]
    assert isinstance(leaf, Sharded) and tuple(leaf.spec)[2] == "model"


# -- training -----------------------------------------------------------------


def _optimizer(kind: str):
    adamw = AdamW(lr=LR)
    return adamw if kind == "adamw" else EigenPre(adamw=adamw, max_dim=32)


def _state(model, opt):
    params = {k: v.clone() for k, v in model.stacked_dict().items()}
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32))


def _train_batch(cfg, step=0):
    source = make_synthetic(cfg, ShapeConfig("t", 16, 4, "train"), seed=0)
    return put_batch(source.global_batch_at(step), "cpu")


_TRAINED: dict = {}


def _trained_1x1(arch, kind):
    if (arch, kind) not in _TRAINED:
        model = _model(arch)
        opt = _optimizer(kind)
        state, metrics = make_train_step(model, opt, torch.float32)(
            _state(model, opt), _train_batch(model.cfg))
        _TRAINED[arch, kind] = (float(metrics["loss"]), state.params)
    return _TRAINED[arch, kind]


def _rel_l2(got: dict, ref: dict) -> float:
    num = sum(float(((got[k].gather() - v) ** 2).sum()) for k, v in
              ref.items())
    return (num / sum(float((v ** 2).sum()) for v in ref.values())) ** 0.5


def mesh_train_errors(arch, kind, spec, fsdp=False):
    """One step's relative loss and parameter (L2) distances from 1x1."""
    loss, params = _trained_1x1(arch, kind)
    model = _model(arch)
    opt = _optimizer(kind)
    progs = steps.build_programs(model, _mesh(spec), fsdp=fsdp,
                                 optimizer=opt, compute_dtype=torch.float32)
    state = placement.put_tree(_state(model, opt), progs.state_shardings)
    state, metrics = progs.train_step(state, _train_batch(model.cfg))
    assert int(state.step) == 1
    return abs(float(metrics["loss"]) / loss - 1), _rel_l2(state.params,
                                                            params)


@pytest.mark.parametrize("spec, fsdp", [(m, False) for m in MESHES]
                         + [("2x1", True), ("2x2", True)])
@pytest.mark.parametrize("kind", ["adamw", "eigenpre"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_equals_the_unsharded_step(arch, kind, spec, fsdp):
    loss_err, param_err = mesh_train_errors(arch, kind, spec, fsdp)
    assert loss_err <= LOSS_TOL, (arch, kind, spec, loss_err)
    assert param_err <= PARAM_TOL, (arch, kind, spec, param_err)


# -- against repro -------------------------------------------------------------


def _pair(arch, b, s):
    r_cfg = r_reduced_config(r_get_config(arch))
    r_model = RLanguageModel(r_cfg)
    r_params = r_model.init(jax.random.PRNGKey(0))
    model = LanguageModel(reduced_config(get_config(arch)), device="cpu")
    params_from_reference(model, {k: np.array(v) for k, v in
                                  r_params.items()})
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, r_cfg.vocab_size, (b, s)).astype(np.int32)
    return r_model, r_params, model, {"tokens": tokens, "labels": tokens}


def _r_train_step(r_model, r_params, batch):
    r_opt = RAdamW(lr=LR, weight_decay=0.0)
    r_state = RTrainState(r_params, r_opt.init(r_params),
                          jnp.zeros((), jnp.int32))
    host = jax.tree.map(np.asarray, r_state)
    r_step = jax.jit(r_make_train_step(r_model, r_opt,
                                       compute_dtype=jnp.float32),
                     compiler_options=FAST_COMPILE)
    _, r_m = r_step(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    return host, r_m


def _mesh_train_from(host_state, model, spec, batch):
    state = train_state_from_reference(host_state, "cpu")
    progs = steps.build_programs(model, _mesh(spec), fsdp=False,
                                 optimizer=AdamW(lr=LR, weight_decay=0.0),
                                 compute_dtype=torch.float32)
    state = placement.put_tree(state, progs.state_shardings)
    return progs.train_step(state, put_batch(batch, "cpu"))


def test_gemma_on_1x3_matches_repro_s_programs():
    """Prefill, four ``serve_step``s and one AdamW step of reduced
    gemma2-2b on 1x3 (8 query heads over 3: the sequence split) against
    repro's unsharded jitted programs on the same weights."""
    r_model, r_params, model, batch = _pair("gemma2-2b", B, S)
    smax = S + GEN
    r_logits, r_caches = jax.jit(lambda p, b: r_model.prefill(p, b, smax),
                                 compiler_options=FAST_COMPILE)(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    r_serve = jax.jit(r_make_serve_step(r_model, jnp.float32),
                      compiler_options=FAST_COMPILE)
    mesh = _mesh("1x3")
    progs = steps.build_programs(model, mesh, compute_dtype=torch.float32)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    logits, caches = progs.prefill(params, put_batch(batch, "cpu"), smax)
    ref = np.asarray(r_logits)
    assert np.abs(logits.numpy() - ref).max() <= R_MODEL_TOL * np.abs(
        ref).max()
    r_tok = jnp.argmax(r_logits, axis=-1).astype(jnp.int32)
    tok = torch.argmax(logits, dim=-1)
    for i in range(GEN):
        assert np.array_equal(tok.numpy(), np.asarray(r_tok)), i
        r_tok, r_caches = r_serve(r_params, r_caches, r_tok,
                                  jnp.asarray(S + i, jnp.int32))
        tok, caches = progs.serve_step(params, caches, tok, S + i)
    train = _train_batch(model.cfg)
    train = {k: v.numpy().astype(np.int32) for k, v in train.items()}
    host, r_m = _r_train_step(r_model, r_params, train)
    _, m = _mesh_train_from(host, model, "1x3", train)
    assert abs(float(m["loss"]) / float(r_m["loss"]) - 1) <= R_LOSS_TOL
    assert abs(float(m["grad_norm"]) / float(r_m["grad_norm"]) - 1) \
        <= R_GNORM_TOL


def test_deepseek_on_2x1_routes_the_global_group_as_repro():
    """Reduced deepseek-v3-671b on 2x1 with 2 x 12 tokens: one routing group
    of 24 (capacity 8) straddles the two rows, where a per-row group of 12
    would take capacity 4.  Prefill logits and one AdamW step hold to
    repro's unsharded programs, and the dropped (token, choice) pairs are
    the 1x1 path's, not the per-row grouping's."""
    r_model, r_params, model, batch = _pair("deepseek-v3-671b", 2, 12)
    mcfg = moe.MoEConfig(d_model=model.cfg.d_model, d_ff=model.cfg.moe_d_ff,
                         n_experts=model.cfg.n_experts, top_k=model.cfg.top_k)
    assert moe.group_size(mcfg, 24) == 24
    assert moe._capacity(mcfg, 24) == 8 and moe._capacity(mcfg, 12) == 4
    smax = 16
    r_logits, _ = jax.jit(lambda p, b: r_model.prefill(p, b, smax),
                          compiler_options=FAST_COMPILE)(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = _mesh("2x1")
    progs = steps.build_programs(model, mesh, compute_dtype=torch.float32)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    tb = put_batch(batch, "cpu")
    mesh_stats, one_stats, row_stats = {}, {}, {}
    logits, _ = progs.prefill(params, tb, smax, stats=mesh_stats)
    model.prefill(model.param_dict(), tb, smax, stats=one_stats)
    for r in range(2):
        model.prefill(model.param_dict(),
                      {k: v[r:r + 1] for k, v in tb.items()}, smax,
                      stats=row_stats)
    ref = np.asarray(r_logits)
    assert np.abs(logits.numpy() - ref).max() <= R_MODEL_TOL * np.abs(
        ref).max()
    mesh_n = [int(t) for t in mesh_stats["moe_dropped"]]
    assert mesh_n == [int(t) for t in one_stats["moe_dropped"]]
    assert sum(mesh_n) > 0
    row_drops = row_stats["moe_dropped"]
    per_row = [int(a) + int(b) for a, b in zip(row_drops[0::2],
                                               row_drops[1::2])]
    assert per_row != mesh_n
    host, r_m = _r_train_step(r_model, r_params, batch)
    _, m = _mesh_train_from(host, model, "2x1", batch)
    assert abs(float(m["loss"]) / float(r_m["loss"]) - 1) <= R_LOSS_TOL


# -- checkpoints, elastic, supervisor --------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "eigenpre"])
def test_reshard_a_1x2_checkpoint_onto_2x1_and_step(kind, tmp_path):
    """Save on 1x2, ``reshard_state`` onto 2x1 and take a step: the same
    as one more step on 1x2."""
    model = _model("gemma2-2b")
    opt = _optimizer(kind)
    p12 = steps.build_programs(model, _mesh("1x2"), fsdp=False,
                               optimizer=opt, compute_dtype=torch.float32)
    state = placement.put_tree(_state(model, opt), p12.state_shardings)
    state, _ = p12.train_step(state, _train_batch(model.cfg, 0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    state, m12 = p12.train_step(state, _train_batch(model.cfg, 1))
    mesh21 = _mesh("2x1")
    ab = steps.abstract_state(model, opt)
    moved, _ = reshard_state(mgr, ab, mesh21, model, fsdp=False)
    leaf = moved.params["embed/tokens"]
    assert isinstance(leaf, Sharded) and leaf.mesh == mesh21
    assert int(moved.step) == 1
    p21 = steps.build_programs(model, mesh21, fsdp=False, optimizer=opt,
                               compute_dtype=torch.float32)
    moved, m21 = p21.train_step(moved, _train_batch(model.cfg, 1))
    assert abs(float(m21["loss"]) / float(m12["loss"]) - 1) <= LOSS_TOL
    ref = {k: v.gather() for k, v in state.params.items()}
    assert _rel_l2(moved.params, ref) <= PARAM_TOL


def test_restore_with_shardings_places_an_unsharded_checkpoint(tmp_path):
    model = _model("deepseek-v3-671b")
    state = _state(model, AdamW())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, blocking=True)
    mesh = _mesh("2x2")
    progs = steps.build_programs(model, mesh, fsdp=True,
                                 compute_dtype=torch.float32)
    restored, _ = mgr.restore(steps.abstract_state(model),
                              shardings=progs.state_shardings)
    for k, v in state.params.items():
        assert isinstance(restored.params[k], Sharded)
        assert torch.equal(restored.params[k].gather(), v)
        assert restored.opt_state.m[k].dtype == torch.bfloat16
    placed = placement.put_tree(state, progs.state_shardings)
    assert placement.device_bytes(restored, mesh) == placement.device_bytes(
        placed, mesh)


def test_supervisor_rolls_back_onto_the_mesh():
    """A failure at step 2 rolls back to the step-2 checkpoint, restored
    onto the mesh by ``state_shardings``; the run ends where an
    uninterrupted one does."""
    def run(inject):
        model = _model("gemma2-2b")
        progs = steps.build_programs(model, _mesh("2x1"), fsdp=True,
                                     optimizer=AdamW(lr=LR),
                                     compute_dtype=torch.float32)
        state = placement.put_tree(_state(model, AdamW(lr=LR)),
                                   progs.state_shardings)
        source = make_synthetic(model.cfg, ShapeConfig("t", 16, 4, "train"))
        data = PrefetchIterator(source)
        armed = {"on": inject}

        def step_fn(state, batch):
            if int(state.step) == 2 and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected node failure")
            return progs.train_step(state, put_batch(batch, "cpu"))

        with tempfile.TemporaryDirectory() as d:
            sup = Supervisor(CheckpointManager(d),
                             SupervisorConfig(checkpoint_every=2))
            final = sup.run(state, data, step_fn, n_steps=3,
                            state_shardings=progs.state_shardings)
        data.close()
        assert not armed["on"]
        return final

    got, ref = run(True), run(False)
    assert int(got.step) == 3
    assert isinstance(got.params["final_norm"], Sharded)
    for k, v in ref.params.items():
        assert torch.equal(got.params[k].gather(), v.gather()), k


# -- launchers -------------------------------------------------------------------


def test_serve_launcher_on_a_1x2_cpu_mesh_gives_the_1x1_tokens(caplog):
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--gen", "4"]
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        gen = serve_cli.main([*argv, "--mesh", "1x2"])
    assert "bytes per device" in caplog.text
    assert np.array_equal(gen, serve_cli.main(argv))


def test_train_launcher_on_a_2x1_cpu_mesh_with_eigenpre(tmp_path,
                                                         monkeypatch, caplog):
    """``train.py --reduced --mesh 2x1 --device cpu --eigenpre --steps 2``,
    with EigenPre's gram bound at 256 (the module docstring's reason)."""
    monkeypatch.setattr(train_cli, "EigenPre",
                        lambda: EigenPre(max_dim=256))
    with caplog.at_level("INFO", logger="repro_torch"):
        state = train_cli.main([
            "--arch", "gemma2-2b", "--reduced", "--mesh", "2x1", "--device",
            "cpu", "--eigenpre", "--steps", "2", "--ckpt-dir",
            str(tmp_path), "--log-every", "1"])
    assert int(state.step) == 2
    assert isinstance(state.params["final_norm"], Sharded)
    assert "step     1 loss" in caplog.text and "bytes per device" in caplog.text


@pytest.mark.parametrize("cli", [serve_cli, train_cli],
                         ids=["serve_cli", "train_cli"])
def test_launchers_take_a_pod_mesh(cli, tmp_path, caplog):
    """``--mesh 2x1x1`` (repro's pod axis) on the CPU: the launcher runs
    on the three-axis mesh and logs the bytes each position holds."""
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--mesh",
            "2x1x1"]
    if cli is serve_cli:
        argv += ["--batch", "2", "--prompt-len", "8", "--gen", "2"]
    else:
        argv += ["--steps", "1", "--batch", "2", "--seq", "16",
                 "--ckpt-dir", str(tmp_path)]
    with caplog.at_level("INFO", logger="repro_torch"):
        cli.main(argv)
    assert "{'pod': 2, 'data': 1, 'model': 1}" in caplog.text
    assert "bytes per device [[" in caplog.text


if __name__ == "__main__":
    torch.set_num_threads(1)
    for arch in ARCHS:
        for spec in MESHES:
            for dtype in (torch.float32, torch.float64):
                errs, bound = mesh_serving_errors(arch, spec, dtype)
                print(arch, spec, dtype, "serve", " ".join(
                    f"{e:.2e}" for e in errs), f"bound {bound:.0e}")
        for kind in ("adamw", "eigenpre"):
            for spec in MESHES:
                print(arch, kind, spec, "train",
                      "loss %.2e params %.2e" % mesh_train_errors(
                          arch, kind, spec))
    sys.exit(0)
