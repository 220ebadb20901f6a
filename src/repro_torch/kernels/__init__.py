"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel lives in ``csrc/<name>.cu`` (built by :mod:`._build` with
``nvcc`` for ``sm_90a`` at first use) and has a wrapper in
``<name>/ops.py`` and a plain PyTorch version in ``<name>/ref.py``. The
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors, and counts its kernel launches in ``<wrapper>.launches``.

``KERNELS`` names each ported kernel with its wrapper, its source and
the TPU kernel it replaces. :func:`device_ops_per_call` and
:func:`workspace_is_zero` check, on the card, how many CUDA operations a
wrapper call issues and that the merging kernels left their tickets
zero.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.kernels._common import workspaces

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.expert_ffn.ops import capacity_ffn
from repro_torch.kernels.grouped_moe.ops import grouped_moe_ffn
from repro_torch.kernels.router_topk.ops import router_topk, router_topk_fused


class PortedKernel(NamedTuple):
    wrapper: object
    source: str
    replaces: str


KERNELS: Dict[str, PortedKernel] = {
    "router_topk_fused": PortedKernel(
        router_topk_fused, "src/repro_torch/kernels/csrc/router_topk.cu",
        "src/repro/kernels/router_topk/kernel.py:155"),
    "grouped_moe_ffn": PortedKernel(
        grouped_moe_ffn, "src/repro_torch/kernels/csrc/grouped_moe.cu",
        "src/repro/kernels/grouped_moe/kernel.py:72"),
    "decode_attention": PortedKernel(
        decode_attention, "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:71"),
    "capacity_ffn": PortedKernel(
        capacity_ffn, "src/repro_torch/kernels/csrc/expert_ffn.cu",
        "src/repro/kernels/expert_ffn/kernel.py:66"),
    "router_topk": PortedKernel(
        router_topk, "src/repro_torch/kernels/csrc/router_topk.cu",
        "src/repro/kernels/router_topk/kernel.py:131"),
}


def launch_counts() -> Dict[str, int]:
    return {name: k.wrapper.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.wrapper.launches = 0


def device_ops_per_call(fn: Callable[[], object], windows: int = 5) -> int:
    """CUDA operations (kernels, memsets, copies) that one call of ``fn``
    puts on the device, counted by ``torch.profiler``.

    A warm-up call (which may build a library or allocate a workspace)
    and one profiled window that is not counted (it starts the
    profiler's tracing) come first. Then each window holds one call. The
    profiler now and then drops records: a window with no CUDA record at
    all, or (seen on the H100 with a programmatic dependent launch, whose
    second kernel starts before the first ends) one record fewer than the
    call issued. The count is therefore the most records a window held,
    and it must have been seen in ``windows`` windows (of at most
    ``4 * windows``); a count that varies more than that raises, and a
    window that records more than another is never discounted."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def window() -> int:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    fn()
    torch.cuda.synchronize()
    window()
    counts = []
    for _ in range(4 * windows):
        counts.append(window())
        if counts.count(max(counts)) == windows:
            break
    top = max(counts)
    if top == 0:
        raise RuntimeError(f"torch.profiler recorded no CUDA operation in "
                           f"{len(counts)} windows of one call")
    if counts.count(top) < windows:
        raise RuntimeError(f"CUDA operations per call differ between "
                           f"profiled windows: {counts}")
    return top


def workspace_is_zero() -> bool:
    """Every ticket workspace allocated so far is all zero (as it must be
    between launches)."""
    return all(int(w.count_nonzero()) == 0 for w in workspaces().values())
