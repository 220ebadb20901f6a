"""Argument checks and ctypes plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


# Ticket workspace of the kernels that merge split work inside their own
# launch (the fused router, and the gating-only router through the same
# kernel): int32 counters, zeroed once when allocated. A
# kernel's merging block resets each ticket it used, so the workspace is
# all zero between launches and no launch needs a memset before it.
# Assumes the launches that use it run one after another on one stream
# (the port issues everything on the current stream): two launches in
# flight at once on different streams would share tickets.
_WORKSPACE: Dict[int, torch.Tensor] = {}
WORKSPACE_MIN_INTS = 1 << 14


def ticket_workspace(device: torch.device, ints: int) -> torch.Tensor:
    """The device's zeroed int32 ticket workspace, of at least ``ints``
    entries. It is allocated (and zeroed) only the first time, and again
    only when a call needs more entries than it holds."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    ws = _WORKSPACE.get(i)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros(max(ints, WORKSPACE_MIN_INTS), dtype=torch.int32,
                         device=torch.device("cuda", i))
        _WORKSPACE[i] = ws
    return ws


def workspaces() -> Dict[int, torch.Tensor]:
    """Each device's ticket workspace allocated so far (for checks that it
    is all zero between launches)."""
    return dict(_WORKSPACE)


# Float32 scratch of the kernels that hand data from one launch to the
# next (the grouped FFN's h): one per device, contents undefined between
# calls, grown on demand, so a call after the first at a shape allocates
# nothing but its output. Same single-stream assumption as the tickets.
_SCRATCH: Dict[int, torch.Tensor] = {}


def scratch_workspace(device: torch.device, floats: int) -> torch.Tensor:
    """The device's float32 scratch workspace, at least ``floats`` long;
    allocated again only when a call needs more than it holds."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    ws = _SCRATCH.get(i)
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32,
                         device=torch.device("cuda", i))
        _SCRATCH[i] = ws
    return ws
