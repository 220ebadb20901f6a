"""Wrapper of the expert FFN kernel on capacity buffers
(``csrc/expert_ffn.cu``).

For CPU tensors it returns the plain version (:mod:`.ref`); for CUDA
tensors it launches the kernel or raises. ``capacity_ffn.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (INT, PTR, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype, stream_ptr)
from repro_torch.kernels.expert_ffn.ref import capacity_ffn_ref

MAX_EXPERTS = 65535   # grid z of csrc/expert_ffn.cu


def _lib():
    lib = _build.library("expert_ffn")
    lib.expert_ffn.argtypes = [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                               PTR, PTR, PTR]
    lib.expert_ffn.restype = INT
    return lib


def capacity_ffn(buf: torch.Tensor, w_gate: torch.Tensor,
                 w_up: Optional[torch.Tensor], w_down: torch.Tensor, *,
                 activation: str = "swiglu") -> torch.Tensor:
    """Per-expert FFN over dense capacity buffers.

    buf (E, C, D); w_gate/w_up (E, D, F) and w_down (E, F, D), all in one
    dtype (float32 or bfloat16); ``w_up`` is None for GELU. Any C, D and
    F (no multiple required). Returns (E, C, D) in buf's dtype; ``h`` and
    the sums stay in float32.
    """
    if activation not in ("swiglu", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if (activation == "swiglu") != (w_up is not None):
        raise ValueError("swiglu takes w_up; gelu takes none")
    tensors = [buf, w_gate, w_down] + ([w_up] if w_up is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return capacity_ffn_ref(buf, w_gate, w_up, w_down, activation)
    what = "capacity_ffn"
    require_cuda(tensors, what)
    require_same_dtype(tensors, what)
    require_contiguous(tensors, what)
    code = dtype_code(buf, what)
    if buf.dim() != 3:
        raise ValueError(f"{what}: buf must be (E, C, D), got "
                         f"{tuple(buf.shape)}")
    E, C, D = buf.shape
    F = w_gate.shape[-1]
    if (tuple(w_gate.shape) != (E, D, F) or tuple(w_down.shape) != (E, F, D)
            or (w_up is not None and w_up.shape != w_gate.shape)):
        raise ValueError(f"{what}: weight shapes {tuple(w_gate.shape)}, "
                         f"{tuple(w_down.shape)} do not match buf "
                         f"{tuple(buf.shape)}")
    if not 1 <= E <= MAX_EXPERTS or min(C, D, F) < 1:
        raise ValueError(f"{what}: needs 1 <= E <= {MAX_EXPERTS} and "
                         f"C, D, F >= 1; got E={E} C={C} D={D} F={F}")
    # h = act(x Wg [, x Wu]) between the two launches, in float32
    h = torch.empty((E, C, F), dtype=torch.float32, device=buf.device)
    out = torch.empty_like(buf)
    lib = _lib()
    status = lib.expert_ffn(
        ptr(buf), ptr(w_gate), ptr(w_up) if w_up is not None else None,
        ptr(w_down), code, E, C, D, F, ptr(h), ptr(out),
        stream_ptr(buf.device))
    _build.check(lib, status, what)
    capacity_ffn.launches += 1
    return out


capacity_ffn.launches = 0
