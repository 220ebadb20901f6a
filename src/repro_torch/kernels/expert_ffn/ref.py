"""Plain PyTorch version of the expert FFN on capacity buffers (what
``csrc/expert_ffn.cu`` computes).

It follows the Pallas kernel (``src/repro/kernels/expert_ffn/kernel.py``),
not the jnp ``expert_ffn``: inputs are cast to float32, ``h`` stays in
float32, and the output is cast to the buffer's dtype once at the end. In
float32 the two agree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def capacity_ffn_ref(buf: torch.Tensor, w_gate: torch.Tensor,
                     w_up: Optional[torch.Tensor], w_down: torch.Tensor,
                     activation: str = "swiglu") -> torch.Tensor:
    """buf (E, C, D); w_gate/w_up (E, D, F); w_down (E, F, D) -> (E, C, D)
    in buf's dtype. ``w_up`` is None for GELU (tanh form)."""
    x = buf.float()
    g = torch.bmm(x, w_gate.float())
    if activation == "swiglu":
        assert w_up is not None
        h = F.silu(g) * torch.bmm(x, w_up.float())
    else:
        h = F.gelu(g, approximate="tanh")
    return torch.bmm(h, w_down.float()).to(buf.dtype)
