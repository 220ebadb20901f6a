"""Argument checks and ctypes plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def ptr(t: torch.Tensor) -> PTR:
    return PTR(t.data_ptr())


def stream_ptr(device: torch.device) -> PTR:
    return PTR(torch.cuda.current_stream(device).cuda_stream)


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the "
                        "kernel (float32 or bfloat16)")
    return code


def require_cuda(tensors: Sequence[torch.Tensor], what: str) -> None:
    """All tensors on one CUDA device, else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on the same CUDA "
                             f"device (got {t.device} and {dev})")


def require_contiguous(tensors: Sequence[torch.Tensor], what: str) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} "
                             "must be contiguous")


def require_same_dtype(tensors: Sequence[torch.Tensor], what: str) -> None:
    dt = tensors[0].dtype
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: mixed dtypes {t.dtype} and {dt}")
