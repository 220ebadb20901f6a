"""Wrapper of the grouped expert FFN kernel (``csrc/grouped_moe.cu``).

For CPU tensors it returns the plain version (:mod:`.ref`); for CUDA
tensors it launches the kernel or raises. ``grouped_moe_ffn.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (I64, INT, PTR, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype, stream_ptr)
from repro_torch.kernels.grouped_moe.ref import grouped_moe_ref

BLOCK_ROWS = 8   # row-tile height the kernel takes (csrc/grouped_moe.cu)


def _lib():
    lib = _build.library("grouped_moe")
    lib.grouped_moe_ffn.argtypes = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                    INT, INT, PTR, PTR, PTR]
    lib.grouped_moe_ffn.restype = INT
    lib.grouped_moe_scratch_floats.argtypes = [INT, INT, INT, INT]
    lib.grouped_moe_scratch_floats.restype = I64
    return lib


def grouped_moe_ffn(x_sorted: torch.Tensor, tile_expert: torch.Tensor,
                    w_gate: torch.Tensor, w_up: Optional[torch.Tensor],
                    w_down: torch.Tensor, *,
                    activation: str = "swiglu") -> torch.Tensor:
    """Per-row expert FFN over the sorted ragged-group layout.

    x_sorted (R, D) with R = 8 * len(tile_expert); tile_expert int32;
    w_gate/w_up (E, D, F) and w_down (E, F, D) in x's dtype (float32 or
    bfloat16); ``w_up`` is None for GELU. Returns (R, D) in x's dtype.
    """
    if activation not in ("swiglu", "gelu"):
        raise ValueError(f"unknown activation {activation!r}")
    if (activation == "swiglu") != (w_up is not None):
        raise ValueError("swiglu takes w_up; gelu takes none")
    tensors = [x_sorted, tile_expert, w_gate, w_down] + (
        [w_up] if w_up is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return grouped_moe_ref(x_sorted, tile_expert, w_gate, w_up, w_down,
                               activation)
    what = "grouped_moe_ffn"
    require_cuda(tensors, what)
    weights = [x_sorted, w_gate, w_down] + ([w_up] if w_up is not None
                                            else [])
    require_same_dtype(weights, what)
    require_contiguous(tensors, what)
    code = dtype_code(x_sorted, what)
    if tile_expert.dtype != torch.int32 or tile_expert.dim() != 1:
        raise TypeError(f"{what}: tile_expert must be a 1-D int32 tensor")
    R, D = x_sorted.shape
    nt = tile_expert.shape[0]
    E, Dw, F = w_gate.shape
    if not 1 <= nt <= 65535 or R != BLOCK_ROWS * nt:
        raise ValueError(f"{what}: R={R} rows must be {BLOCK_ROWS} x "
                         f"{nt} tiles, 1 <= tiles <= 65535")
    if Dw != D or tuple(w_down.shape) != (E, F, D) or (
            w_up is not None and w_up.shape != w_gate.shape):
        raise ValueError(f"{what}: weight shapes {tuple(w_gate.shape)}, "
                         f"{tuple(w_down.shape)} do not match D={D}")
    lib = _lib()
    # split-K partial sums; the kernel source sizes them
    scratch = torch.empty(
        lib.grouped_moe_scratch_floats(nt, D, F, int(w_up is not None)),
        dtype=torch.float32, device=x_sorted.device)
    out = torch.empty_like(x_sorted)
    status = lib.grouped_moe_ffn(
        ptr(x_sorted), ptr(tile_expert), ptr(w_gate),
        ptr(w_up) if w_up is not None else None, ptr(w_down), code, nt, D, F,
        E, ptr(scratch), ptr(out), stream_ptr(x_sorted.device))
    _build.check(lib, status, what)
    grouped_moe_ffn.launches += 1
    return out


grouped_moe_ffn.launches = 0
