"""Shared model building blocks: norms, RoPE, activations, masking.

The twin of ``repro.models.common``: the same arithmetic, in the same
precision (norms and RoPE angles in float32, the result in the input's
dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul(a: torch.Tensor, b: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """``a @ b`` in the two operands' promoted dtype, as ``jnp.einsum``
    promotes mixed operands (float32 frames against bfloat16 weights in
    whisper's encoder).  With ``f32``, the product in at least float32 and
    returned so (a partial sum that a mesh program adds to others before
    one rounding to the operands' dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if f32:
        dt = torch.promote_types(dt, torch.float32)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, *ops: torch.Tensor, f32: bool = False) -> torch.Tensor:
    """``jnp.einsum(eq, *ops)`` in the operands' promoted dtype; with
    ``f32``, as ``preferred_element_type=float32``: the product in at least
    float32, returned in float32."""
    dt = torch.float32 if f32 else ops[0].dtype
    for o in ops:
        dt = torch.promote_types(dt, o.dtype)
    out = torch.einsum(eq, *(o.to(dt) for o in ops))
    return out.float() if f32 else out


def partial_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(eq, *ops)`` in at least float32, returned so: one
    device's part of a product that a mesh program sums over its devices
    before one rounding to the operands' dtype (the unsharded product's
    float32 accumulation, in another order)."""
    dt = torch.float32
    for o in ops:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def sum_partials(parts, device, dtype) -> torch.Tensor:
    """The devices' partial sums of a product (each in at least float32)
    added on ``device`` in device order and rounded once to ``dtype``, as
    the unsharded product accumulates before its one rounding."""
    out = None
    for t in parts:
        t = t.to(device)
        out = t if out is None else out + t
    return out.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


# -- rotary position embeddings ------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta**exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    The head dim splits into halves (not interleaved pairs), and the angles
    are float32 whatever the input's dtype.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    angles = positions[..., :, None, None].float() * freqs  # (...,S,1,d/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- masking -------------------------------------------------------------------


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int | None = None) -> torch.Tensor:
    """(Sq, Sk) boolean mask: k may attend iff k_pos <= q_pos (& window)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m = torch.logical_and(m, k_pos[None, :] > q_pos[:, None] - window)
    return m


#: The value a masked score takes (``repro``'s, not ``-inf``).
NEG_INF = -1e30
