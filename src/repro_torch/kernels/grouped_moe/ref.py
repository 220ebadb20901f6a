"""Plain PyTorch version of the grouped expert FFN (what
``csrc/grouped_moe.cu`` computes): one float32 product per run of row
tiles owned by the same expert."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def grouped_moe_ref(x_sorted: torch.Tensor, tile_expert: torch.Tensor,
                    w_gate: torch.Tensor, w_up: Optional[torch.Tensor],
                    w_down: torch.Tensor,
                    activation: str = "swiglu") -> torch.Tensor:
    """x_sorted (R, D); tile_expert (R // block_rows,) int; w_gate/w_up
    (E, D, F); w_down (E, F, D) -> (R, D) in x's dtype. Reads
    ``tile_expert`` on the host."""
    R, D = x_sorted.shape
    nt = tile_expert.shape[0]
    rows = R // nt
    E = w_gate.shape[0]
    te = [min(max(int(e), 0), E - 1) for e in tile_expert.tolist()]
    out = torch.zeros((R, D), dtype=torch.float32, device=x_sorted.device)
    t0 = 0
    while t0 < nt:
        t1 = t0
        while t1 < nt and te[t1] == te[t0]:
            t1 += 1
        e = te[t0]
        xs = x_sorted[t0 * rows:t1 * rows].float()
        if activation == "swiglu":
            assert w_up is not None
            h = F.silu(xs @ w_gate[e].float()) * (xs @ w_up[e].float())
        else:
            h = F.gelu(xs @ w_gate[e].float(), approximate="tanh")
        out[t0 * rows:t1 * rows] = h @ w_down[e].float()
        t0 = t1
    return out.to(x_sorted.dtype)
