"""The port's roofline package (``repro_torch.roofline``) against repro's.

* The cost algebra, the roofline terms and the MODEL_FLOPS conventions:
  twins of ``tests/test_roofline.py``'s, on the H100 constants.
* ``active_params``, ``model_flops`` and ``slstm_extra_flops`` equal
  repro's exactly, for all ten configs at published width and the four
  workload shapes.
* The collective count (``roofline.collective_bytes``): the bytes of a
  one-layer reduced gemma2-2b prefill on a CPU 1x2 mesh (heads split) and
  of a train step on 2x1 under FSDP equal counts written out here from the
  specs; a 1x1 mesh counts nothing; serving with the count running gives
  the logits of serving without it, bit for bit.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.configs.registry import get_config as r_get_config
from repro.roofline import active_params as r_active_params
from repro.roofline import model_flops as r_model_flops
from repro.roofline import slstm_extra_flops as r_slstm_extra_flops
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data import make_synthetic
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.roofline import (
    CostVector,
    Roofline,
    active_params,
    collective_bytes,
    cost_vector,
    extrapolate,
    model_flops,
    slstm_extra_flops,
)
from repro_torch.roofline import constants as C
from repro_torch.sharding import placement
from repro_torch.train import TrainState, put_batch, steps

B, S = 2, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are tiny, and parallel
    test workers would otherwise each start one thread a core."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def test_h100_constants():
    """NVIDIA's H100 SXM5 data sheet (dense bfloat16, HBM3) and one
    InfiniBand NDR link a card; no TPU number is left."""
    assert C.PEAK_FLOPS_BF16 == 989e12
    assert C.HBM_BW == 3.35e12
    assert C.HBM_PER_CHIP == 80e9
    assert C.LINK_BW == 400e9 / 8
    assert not hasattr(C, "ICI_LINK_BW")


def test_cost_vector_algebra_and_extrapolation():
    base = CostVector(10.0, 100.0, {"all-reduce": 5.0, "total": 5.0})
    g2 = CostVector(14.0, 160.0, {"all-reduce": 7.0, "total": 7.0})
    # repeats=[3]: total = base + (3-1)*(g2-base)
    total = extrapolate(base, [g2], [3])
    assert total.flops == 10 + 2 * 4
    assert total.bytes_accessed == 100 + 2 * 60
    assert total.collective["total"] == 5 + 2 * 2
    scaled = total.scale(2.0)
    assert scaled.flops == 2 * total.flops


def test_roofline_terms_and_dominant():
    rl = Roofline(flops=C.PEAK_FLOPS_BF16, bytes_accessed=0.0,
                  collective_bytes=0.0, chips=1, model_flops=C.PEAK_FLOPS_BF16)
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert rl.dominant == "compute"
    assert abs(rl.roofline_fraction - 1.0) < 1e-9
    rl2 = Roofline(flops=0.0, bytes_accessed=C.HBM_BW * 2, collective_bytes=0.0,
                   chips=1, model_flops=C.PEAK_FLOPS_BF16)
    assert rl2.dominant == "memory"
    assert abs(rl2.bound_time - 2.0) < 1e-9
    rl3 = Roofline(flops=0.0, bytes_accessed=0.0,
                   collective_bytes=C.LINK_BW * 4, chips=2, model_flops=0.0)
    assert rl3.dominant == "collective" and abs(rl3.bound_time - 2.0) < 1e-9


def test_model_flops_conventions():
    dense = get_config("codeqwen1.5-7b")
    moe = get_config("deepseek-v3-671b")
    assert active_params(dense) == active_params(dense)  # deterministic
    # MoE active < total: 256 routed -> 8 active per token
    assert active_params(moe) < 0.1 * LanguageModel(moe,
                                                    device="meta").n_params()
    train = SHAPES["train_4k"]
    decode = SHAPES["decode_32k"]
    assert model_flops(dense, train) > model_flops(dense, decode) * 1e4
    # decode counts one token per sequence
    assert model_flops(dense, decode) == 2.0 * active_params(dense) * 128


def test_slstm_correction_only_for_slstm_archs():
    assert slstm_extra_flops(get_config("codeqwen1.5-7b"),
                             SHAPES["train_4k"]) == 0.0
    assert slstm_extra_flops(get_config("xlstm-125m"), SHAPES["train_4k"]) > 0


def test_cost_vector_from_analysis_dict():
    cv = cost_vector({"flops": 7.0, "bytes accessed": 3.0}, {"total": 1.0})
    assert cv.flops == 7.0 and cv.bytes_accessed == 3.0
    cv0 = cost_vector({}, {})
    assert cv0.flops == 0.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_repro(arch, shape):
    """The 6ND/2ND arithmetic on published widths, exactly repro's."""
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    assert active_params(cfg) == r_active_params(r_cfg)
    assert model_flops(cfg, SHAPES[shape]) == r_model_flops(r_cfg,
                                                           SHAPES[shape])
    assert slstm_extra_flops(cfg, SHAPES[shape]) == r_slstm_extra_flops(
        r_cfg, SHAPES[shape])


# -- the collective count ------------------------------------------------------


def _one_layer():
    """Reduced gemma2-2b with one repeat of its (attn_local, attn) group."""
    cfg = reduced_config(get_config("gemma2-2b"))
    cfg = dataclasses.replace(cfg, pattern=((1, cfg.pattern[0][1]),),
                              n_layers=len(cfg.pattern[0][1]))
    return LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))


def _prefill(model, spec, counting=True):
    progs = steps.build_programs(model, parse_mesh(spec, "cpu"),
                                 compute_dtype=torch.float32)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    batch = serve_cli.lm_batch(model.cfg, B, S, 0, "cpu")
    with collective_bytes() as coll:
        if counting:
            logits, caches = progs.prefill(params, batch, S + 2)
    if not counting:
        logits, caches = progs.prefill(params, batch, S + 2)
    tok = torch.argmax(logits, dim=-1)
    return coll, [logits, progs.decode_step(params, caches, tok, S)[0]]


def _train(model, spec, fsdp):
    opt = AdamW(lr=3e-3)
    progs = steps.build_programs(model, parse_mesh(spec, "cpu"), fsdp=fsdp,
                                 optimizer=opt, compute_dtype=torch.float32)
    params = {k: v.clone() for k, v in model.stacked_dict().items()}
    state = placement.put_tree(
        TrainState(params, opt.init(params),
                   torch.zeros((), dtype=torch.int32)),
        progs.state_shardings)
    source = make_synthetic(model.cfg, ShapeConfig("t", S, 4, "train"),
                            seed=0)
    with collective_bytes() as coll:
        progs.train_step(state, put_batch(source.global_batch_at(0), "cpu"))
    return coll, progs


def test_prefill_collectives_on_1x2_are_the_specs_count():
    """Heads, MLP columns and vocab split over a model axis of 2: the
    embedding sums its two vocab ranges' lookups, each block sums two
    float32 partial products after its attention and after its MLP, and
    the head gathers its two vocab halves of the last token's logits."""
    model = _one_layer()
    cfg = model.cfg
    coll, _ = _prefill(model, "1x2")
    act = B * S * cfg.d_model * 4  # one (B, S, d) float32 tensor
    blocks = len(cfg.pattern[0][1])
    assert coll == {
        "all-reduce": 2 * act + blocks * 2 * (2 * act),
        "all-gather": B * cfg.vocab_size * 4,
        "total": 2 * act + blocks * 4 * act + B * cfg.vocab_size * 4,
    }


def test_fsdp_train_collectives_on_2x1_are_the_specs_count():
    """Every parameter has a ``d_model`` axis, split over the data axis of
    2 under FSDP: each row gathers each parameter once for its forward
    (the tied embedding twice: its lookup and the head), and each
    gradient is reduce-scattered back, each of the 2 positions' operand
    the whole gradient.  No slice is held twice, so nothing is
    all-reduced."""
    model = _one_layer()
    coll, progs = _train(model, "2x1", fsdp=True)
    sizes = {k: v.numel() * 4 for k, v in model.stacked_dict().items()}
    assert all(s.spec is not None and "data" in s.spec
               for s in progs.state_shardings.params.values())
    assert model.cfg.tie_embeddings
    total = sum(sizes.values())
    assert coll == {
        "all-gather": total + sizes["embed/tokens"],
        "reduce-scatter": 2 * total,
        "total": 3 * total + sizes["embed/tokens"],
    }


def test_data_parallel_train_all_reduces_every_gradient():
    """Under TP rules on 2x1 each parameter is whole on both rows: one
    all-reduce of every gradient, each position's operand its own."""
    model = _one_layer()
    coll, _ = _train(model, "2x1", fsdp=False)
    total = sum(v.numel() * 4 for v in model.stacked_dict().values())
    assert coll == {"all-reduce": 2 * total, "total": 2 * total}


def test_a_1x1_mesh_counts_no_collective():
    model = _one_layer()
    assert _prefill(model, "1x1")[0] == {"total": 0}
    assert _train(model, "1x1", fsdp=False)[0] == {"total": 0}


def test_serving_with_the_count_running_is_bitwise_serving_without():
    model = _one_layer()
    _, counted = _prefill(model, "1x2", counting=True)
    _, plain = _prefill(model, "1x2", counting=False)
    assert all(torch.equal(a, b) for a, b in zip(counted, plain))


def test_nested_counts_each_see_their_own_collectives():
    """An inner count takes what runs inside it; on exit the outer one
    counts again, even when both are empty when the inner one starts."""
    from repro_torch.roofline.collectives import record

    with collective_bytes() as outer:
        with collective_bytes() as inner:
            record("all-reduce", 8)
        record("all-gather", 4)
    record("all-gather", 2)  # no count runs: dropped
    assert inner == {"all-reduce": 8, "total": 8}
    assert outer == {"all-gather": 4, "total": 4}
