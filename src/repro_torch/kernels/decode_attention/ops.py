"""Wrapper of the flash-decode kernel (``csrc/decode_attention.cu``).

For CPU tensors it returns the plain version (:mod:`.ref`); for CUDA
tensors it launches the kernel or raises. ``decode_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (F32, I64, INT, PTR, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype, stream_ptr)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

MAX_D, MAX_G, MAX_GD, MAX_B = 256, 16, 1024, 65535   # csrc/decode_attention.cu


def _lib():
    lib = _build.library("decode_attention")
    lib.decode_attention.argtypes = [PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                     INT, INT, I64, I64, I64, I64, F32, PTR,
                                     PTR]
    lib.decode_attention.restype = INT
    return lib


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """q (B, N, G, D) contiguous; k, v (B, T, N, D) whose last two axes are
    contiguous (batch and T strides are free, so ``cache[:, :kv_len]`` is
    taken as it is); valid_len (B,) int32. Returns (B, N, G, D)."""
    if all(t.device.type == "cpu" for t in (q, k, v, valid_len)):
        return decode_attention_ref(q, k, v, valid_len)
    what = "decode_attention"
    require_cuda([q, k, v, valid_len], what)
    require_same_dtype([q, k, v], what)
    require_contiguous([q, valid_len], what)
    code = dtype_code(q, what)
    if valid_len.dtype != torch.int32 or valid_len.dim() != 1:
        raise TypeError(f"{what}: valid_len must be a 1-D int32 tensor")
    B, N, G, D = q.shape
    T = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, T, N, D):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"{(B, T, N, D)}")
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{what}: {name} needs contiguous (N, D) rows; "
                             f"strides {t.stride()}")
    if valid_len.shape[0] != B:
        raise ValueError(f"{what}: valid_len has {valid_len.shape[0]} rows, "
                         f"batch is {B}")
    if D > MAX_D or G > MAX_G or G * D > MAX_GD or B > MAX_B:
        raise ValueError(f"{what}: needs D <= {MAX_D}, G <= {MAX_G}, "
                         f"G*D <= {MAX_GD}, B <= {MAX_B}; got B={B} G={G} "
                         f"D={D}")
    out = torch.empty_like(q)
    lib = _lib()
    status = lib.decode_attention(
        ptr(q), ptr(k), ptr(v), ptr(valid_len), code, B, N, G, D, T,
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), D ** -0.5,
        ptr(out), stream_ptr(q.device))
    _build.check(lib, status, what)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
