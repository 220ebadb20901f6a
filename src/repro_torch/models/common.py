"""Shared building blocks: initializers, norms, RoPE, activations.

Counterpart of ``repro.models.common``. Three details keep the port
equal to the reference: norms compute in float32 with ``eps=1e-6`` and
LayerNorm's population variance; RoPE rotates the two halves of each
head vector (not interleaved pairs); GELU is the tanh approximation
(``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; the streams differ from jax.random)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
    """Fan-in-scaled normal truncated at +-3 std (LeCun normal).

    ``fan_in`` is ``shape[-2]``, so a stacked ``(num_blocks, in, out)``
    weight is scaled like one ``(in, out)`` weight. Sampled by inverse
    CDF on the generator's device.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-3.0 / math.sqrt(2.0)))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.uniform_(2.0 * lo - 1.0, 1.0 - 2.0 * lo, generator=gen)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-3.0 * std, 3.0 * std)
    return t.to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, 0.02, generator=gen).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, lead: Tuple[int, ...] = (),
              device=None) -> Params:
    p = {"scale": torch.ones(lead + (dim,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (dim,), device=device)
    return p


def apply_norm(kind: str, params: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = ((x32 - mu) * torch.rsqrt(var + eps) * params["scale"].float()
             + params["bias"].float())
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    angles = positions[..., :, None].float() * inv_freq     # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")
