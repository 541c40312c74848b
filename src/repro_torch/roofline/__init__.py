from repro_torch.roofline.analysis import (  # noqa: F401
    CostVector,
    Roofline,
    active_params,
    cost_vector,
    extrapolate,
    model_flops,
    slstm_extra_flops,
)
from repro_torch.roofline.collectives import collective_bytes  # noqa: F401
