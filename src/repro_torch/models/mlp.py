"""Dense feed-forward blocks (SwiGLU / GELU); weights ``(in, out)``."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, gelu


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             lead: Tuple[int, ...] = ()) -> Params:
    if activation == "swiglu":
        return {
            "w_gate": dense_init(gen, lead + (d_model, d_ff)),
            "w_up": dense_init(gen, lead + (d_model, d_ff)),
            "w_down": dense_init(gen, lead + (d_ff, d_model)),
        }
    return {
        "w_in": dense_init(gen, lead + (d_model, d_ff)),
        "w_out": dense_init(gen, lead + (d_ff, d_model)),
    }


def mlp_forward(params: Params, x: torch.Tensor,
                activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    return gelu(x @ params["w_in"]) @ params["w_out"]
