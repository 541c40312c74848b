"""Roofline terms from the dry run's counts, the twin of
``repro.roofline.analysis`` on the H100 constants.

    compute    = FLOPs              / (chips * PEAK_FLOPS_BF16)
    memory     = bytes_accessed     / (chips * HBM_BW)
    collective = collective_bytes   / (chips * LINK_BW)

The counts come from running a step on ``"meta"`` tensors
(``launch.dryrun_lib``), which is exactly linear in depth.  The
L-extrapolation is kept for time: count the step with every group repeat
= 1 (``cost_1``) and with group g's repeat = 2 (``cost_g2``); the slope
``cost_g2 - cost_1`` is group g's exact per-layer cost (layers within a
group are identical), so

    cost(full) = cost_1 + sum_g (repeat_g - 1) * slope_g .

MODEL_FLOPS uses the 6*N*D convention (N = params, N_active for MoE,
D = tokens per step); decode steps use D = global_batch (one token each).
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline import constants as C


@dataclasses.dataclass
class CostVector:
    flops: float
    bytes_accessed: float
    collective: dict[str, float]

    def __add__(self, o):
        keys = set(self.collective) | set(o.collective)
        return CostVector(
            self.flops + o.flops,
            self.bytes_accessed + o.bytes_accessed,
            {k: self.collective.get(k, 0) + o.collective.get(k, 0) for k in keys},
        )

    def scale(self, a: float):
        return CostVector(
            self.flops * a,
            self.bytes_accessed * a,
            {k: v * a for k, v in self.collective.items()},
        )

    def __sub__(self, o):
        return self + o.scale(-1.0)


def cost_vector(cost_analysis: dict, coll: dict) -> CostVector:
    return CostVector(
        flops=max(float(cost_analysis.get("flops", 0.0)), 0.0),
        bytes_accessed=max(float(cost_analysis.get("bytes accessed", 0.0)), 0.0),
        collective=dict(coll),
    )


def extrapolate(cost_1: CostVector, group_costs_2: list[CostVector],
                repeats: list[int]) -> CostVector:
    """cost_1: all repeats=1. group_costs_2[g]: repeat_g=2, others 1."""
    total = cost_1
    for c2, r in zip(group_costs_2, repeats):
        slope = c2 - cost_1
        total = total + slope.scale(max(r - 1, 0))
    return total


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: float
    extra_flops: float = 0.0  # analytic correction (e.g. sLSTM time-scan)

    @property
    def t_compute(self) -> float:
        return (self.flops + self.extra_flops) / (self.chips * C.PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.chips * C.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * C.LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops + self.extra_flops
        return self.model_flops / counted if counted > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the roofline bound that is useful model compute."""
        if self.bound_time <= 0:
            return 0.0
        t_model = self.model_flops / (self.chips * C.PEAK_FLOPS_BF16)
        return t_model / self.bound_time

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "extra_flops": self.extra_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D convention)
# ---------------------------------------------------------------------------


def active_params(cfg) -> int:
    """Parameters touched per token: total minus inactive experts."""
    from repro_torch.models.lm import LanguageModel

    total = LanguageModel(cfg, device="meta").n_params()
    if not cfg.n_experts:
        return total
    # count MoE layers
    moe_layers = sum(
        r for r, kinds in cfg.pattern for k in kinds if k.endswith("_moe")
    )
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    inactive = moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def model_flops(cfg, shape) -> float:
    n_active = active_params(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def slstm_extra_flops(cfg, shape) -> float:
    """Analytic correction for the sLSTM time scan.  On the card the
    port's scan is one replay of a captured CUDA graph, which a count of
    the ops it dispatches sees once (``models.xlstm``), as ``repro``'s HLO
    count sees its ``while`` body once.

    Per step per token: recurrent matmul 2*(d/h)*(4d/h)*h = 8 d^2 / h plus
    O(d) gate math (negligible).  Multiplied by sLSTM layer count and by the
    (trip_count - 1) steps the count misses.
    """
    n_slstm = sum(
        r for r, kinds in cfg.pattern for k in kinds if k == "slstm"
    )
    if not n_slstm:
        return 0.0
    d, h = cfg.d_model, cfg.n_kv_heads
    per_tok = 8.0 * d * d / h
    seq = shape.seq_len if shape.kind != "decode" else 1
    missed = max(seq - 1, 0) * shape.global_batch
    factor = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd
    return factor * n_slstm * per_tok * missed
