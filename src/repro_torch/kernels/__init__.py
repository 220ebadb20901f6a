"""Hand-written Hopper kernels of the port and their wrappers.

Each kernel lives in ``csrc/<name>.cu`` (built by :mod:`._build` with
``nvcc`` for ``sm_90a`` at first use) and has a wrapper in
``<name>/ops.py`` and a plain PyTorch version in ``<name>/ref.py``. The
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors, and counts its kernel launches in ``<wrapper>.launches``.

``KERNELS`` names each ported kernel with its wrapper, its source and
the TPU kernel it replaces.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

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
