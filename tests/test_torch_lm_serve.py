"""The language model's decode path and its launcher against repro's, on the CPU.

For each of the six attention-family configs at reduced width and each
dtype, ``repro``'s weights carried across: prefill, then 6 decode steps
teacher-forced with ``repro``'s greedy tokens, every step's logits and the
caches after the last step held to ``repro``'s at the tolerances of
``tests/test_torch_lm.py`` (``assert_model_close``); greedy tokens equal wherever
``repro``'s top-2 margin exceeds twice the logits' bound (then no token can
flip).  Also the port alone: prefill of S - 1 tokens plus one decode step
against prefill of S, the static cross caches, the serve step, and
``python -m repro_torch.launch.serve --arch``.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import (  # noqa: F401  (_float32_jax: autouse fixture)
    ARCHS,
    DTYPES,
    NEW_KINDS,
    SMAX,
    S,
    _float32_jax,
    assert_model_close,
    assert_tree_close,
    f64,
    make_pair,
)

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LanguageModel
from repro_torch.train.steps import cast_tree, make_serve_step

STEPS = 6
#: Prefill of S - 1 tokens plus one decode step against prefill of S, in
#: float32, relative to max |logit|: repro's own bound for the same check
#: (tests/test_archs_smoke.py).
CONSISTENCY_TOL = 2e-4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


# ---------------------------------------------------------------------------
# Decode against repro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_steps_match_repro(pair, dtype):
    r_params, p_params = pair.params(dtype)
    r_logits, r_caches = jax.jit(pair.r_model.prefill, static_argnums=2)(
        r_params, pair.r_batch(), SMAX)
    logits, caches = pair.model.prefill(p_params, pair.p_batch(), SMAX)
    exact_params = pair.exact_params()
    exact, exact_caches = pair.model.prefill(
        exact_params, pair.p_batch(torch.float64), SMAX)
    assert_model_close(logits, r_logits, pair.arch, dtype, "prefill logits",
                       exact)
    r_step = jax.jit(pair.r_model.decode_step)
    tok = np.asarray(jnp.argmax(r_logits, axis=-1)).astype(np.int32)
    for i in range(STEPS):
        pos = S + i
        r_logits, r_caches = r_step(r_params, r_caches, jnp.asarray(tok),
                                    jnp.asarray(pos, jnp.int32))
        logits, caches = pair.model.decode_step(
            p_params, caches, torch.as_tensor(tok).long(), pos)
        exact, exact_caches = pair.model.decode_step(
            exact_params, exact_caches, torch.as_tensor(tok).long(), pos)
        bound = assert_model_close(logits, r_logits, pair.arch, dtype,
                                   f"decode step {i}", exact)
        ref = f64(r_logits)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * bound
        got_tok = logits.argmax(-1).numpy()
        assert np.array_equal(got_tok[clear], ref.argmax(-1)[clear]), \
            (pair.arch, dtype, i)
        tok = ref.argmax(-1).astype(np.int32)  # teacher-forced
    assert_tree_close(caches, r_caches, pair.arch, dtype,
                      f"cache after {STEPS} steps", exact_caches)


def test_prefill_of_all_but_one_plus_a_step_equals_prefill(pair):
    model, p_params = pair.model, pair.model.param_dict()
    batch = pair.p_batch()
    full, _ = model.prefill(p_params, batch, SMAX)
    head = dict(batch, tokens=batch["tokens"][:, :-1],
                labels=batch["labels"][:, :-1])
    _, caches = model.prefill(p_params, head, SMAX)
    step, _ = model.decode_step(p_params, caches, batch["tokens"][:, -1],
                                S - 1)
    err = float((step - full).abs().max() / full.abs().max())
    assert err <= CONSISTENCY_TOL, (pair.arch, err)


def test_cross_caches_are_written_once_by_prefill():
    pair = make_pair("whisper-large-v3")
    logits, caches = pair.model.prefill(pair.model.param_dict(),
                                        pair.p_batch(), SMAX)
    cross = [c["cross"][n].clone() for g in caches for c in g.values()
             for n in ("k", "v")]
    selves = [c["self"]["k"] for g in caches for c in g.values()]
    assert all(torch.count_nonzero(x) > 0 for x in cross)
    tok = logits.argmax(-1)
    for i in range(3):
        logits, caches = pair.model.decode_step(pair.model.param_dict(),
                                                caches, tok, S + i)
        tok = logits.argmax(-1)
    after = [c["cross"][n] for g in caches for c in g.values()
             for n in ("k", "v")]
    assert all(torch.equal(a, b) for a, b in zip(cross, after))
    # The self caches were written in place at the decoded positions.
    assert all(torch.count_nonzero(k[:, :, S: S + 3]) > 0 for k in selves)


def test_serve_step_is_greedy_and_casting_once_makes_its_cast_free():
    pair = make_pair("gemma2-2b")
    params = cast_tree(pair.model.param_dict(), torch.bfloat16)
    again = cast_tree(params, torch.bfloat16)
    assert all(again[k] is params[k] for k in params)
    nested = cast_tree({"a": [torch.ones(2), torch.arange(3)]}, torch.float64)
    assert nested["a"][0].dtype == torch.float64
    assert nested["a"][1].dtype == torch.int64
    step = make_serve_step(pair.model, torch.bfloat16)
    logits, caches = pair.model.prefill(params, pair.p_batch(), SMAX)
    assert all(c.dtype == torch.bfloat16 for c in jax.tree.leaves(caches))
    tok = logits.argmax(-1)
    ref_logits, _ = pair.model.decode_step(
        params, jax.tree.map(torch.clone, caches), tok, S)
    nxt, caches = step(params, caches, tok, S)
    assert torch.equal(nxt, ref_logits.argmax(-1))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


GEMMA = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--batch",
         "2", "--prompt-len", "8", "--gen", "4"]


def test_launcher_serves_the_reduced_lm_on_the_cpu(capsys, caplog):
    with caplog.at_level("INFO", logger="repro_torch.serve"):
        gen = serve_cli.main(GEMMA)
    assert gen.shape == (2, 4)
    assert ((0 <= gen) & (gen < 512)).all()
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == gen.tolist()
    said = " ".join(r.getMessage() for r in caplog.records)
    assert "on cpu" in said and "prefill" in said and "decode 4 tokens" in said


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_launcher_equals_the_model_driven_by_hand(dtype):
    gen = serve_cli.main([*GEMMA, "--dtype", dtype, "--seed", "5"])
    cfg = reduced_config(get_config("gemma2-2b"))
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    batch = serve_cli.lm_batch(cfg, 2, 8, 5, "cpu")
    tdt = DTYPES[dtype][1]
    params = cast_tree(model.param_dict(), tdt)
    logits, caches = model.prefill(params, batch, 12)
    tok = logits.argmax(-1)
    out = [tok]
    step = make_serve_step(model, tdt)
    for i in range(3):
        tok, caches = step(params, caches, tok, 8 + i)
        out.append(tok)
    assert np.array_equal(gen, torch.stack(out, 1).numpy())


def test_launcher_serves_whisper_with_seeded_frames():
    gen = serve_cli.main(["--arch", "whisper-large-v3", "--reduced",
                          "--device", "cpu", "--batch", "3", "--prompt-len",
                          "5", "--gen", "3"])
    assert gen.shape == (3, 3)
    cfg = reduced_config(get_config("whisper-large-v3"))
    a = serve_cli.lm_batch(cfg, 3, 5, 0, "cpu")
    b = serve_cli.lm_batch(cfg, 3, 5, 0, "cpu")
    assert a["frames"].shape == (3, cfg.enc_seq, cfg.d_model)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_launcher_lm_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "gemma2-2b", "--reduced", "--gen", "2"])


@pytest.mark.parametrize("args, said", [
    (["--mesh", "2x2x1"], "waits for the dry-run slice"),
    (["--mesh", "2xq"], "bad mesh spec"),
    (["--arch", "gpt-5"], "unknown arch")])
def test_launcher_refuses_what_the_lm_path_does_not_port(args, said, capsys):
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu", *args]
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(argv)
    assert exc.value.code == 2
    assert said in capsys.readouterr().err


@pytest.mark.parametrize("arch", sorted(NEW_KINDS))
def test_launcher_serves_the_other_block_families(arch):
    """``--arch`` takes every config: the four that once were refused by
    block kind serve at reduced width, their greedy tokens equal to the
    model's own prefill and decode loop on the launcher's seeded weights
    and prompts."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "3"]
    gen = serve_cli.main(argv)
    cfg = reduced_config(get_config(arch))
    assert gen.shape == (2, 3) and ((gen >= 0) & (gen < cfg.vocab_size)).all()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params = model.param_dict()
    logits, caches = model.prefill(params, serve_cli.lm_batch(cfg, 2, 8, 0,
                                                              "cpu"), 11)
    tok = logits.argmax(-1)
    out = [tok]
    for i in range(2):
        logits, caches = model.decode_step(params, caches, tok, 8 + i)
        tok = logits.argmax(-1)
        out.append(tok)
    assert np.array_equal(gen, torch.stack(out, 1).numpy())
