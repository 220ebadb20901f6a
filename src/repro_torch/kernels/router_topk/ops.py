"""Wrappers of the router kernels (``csrc/router_topk.cu``): the fused
router (B1) and the gating-only router (B5).

For CPU tensors they return the plain versions (:mod:`.ref`); for CUDA
tensors they launch the kernel or raise. ``router_topk_fused.launches``
and ``router_topk.launches`` count kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (INT, PTR, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype, stream_ptr)
from repro_torch.kernels.router_topk.ref import (router_topk_fused_ref,
                                                 router_topk_ref)

MAX_EXPERTS, MAX_K, TILE_TOKENS = 128, 8, 64   # csrc/router_topk.cu


def _lib():
    lib = _build.library("router_topk")
    lib.router_topk_fused.argtypes = [PTR, PTR, INT, INT, INT, INT, INT, INT,
                                      PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                      PTR, PTR, PTR]
    lib.router_topk_fused.restype = INT
    lib.router_topk.argtypes = [PTR, PTR, INT, INT, INT, INT, INT, INT, PTR,
                                PTR, PTR]
    lib.router_topk.restype = INT
    return lib


def _check_args(what: str, x: torch.Tensor, router_w: torch.Tensor,
                k: int) -> int:
    """Validate a CUDA call; returns the dtype code."""
    require_cuda([x, router_w], what)
    require_same_dtype([x, router_w], what)
    require_contiguous([x, router_w], what)
    code = dtype_code(x, what)
    if x.dim() != 2 or router_w.dim() != 2 or x.shape[1] != router_w.shape[0]:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} x "
                         f"{tuple(router_w.shape)} do not chain")
    N = x.shape[0]
    E = router_w.shape[1]
    if N < 1 or not 1 <= E <= MAX_EXPERTS or not 1 <= k <= min(MAX_K, E):
        raise ValueError(f"{what}: needs N >= 1, E <= {MAX_EXPERTS}, "
                         f"k <= min({MAX_K}, E); got N={N} E={E} k={k}")
    return code


def router_topk(x: torch.Tensor, router_w: torch.Tensor, *, k: int,
                valid_experts: Optional[int] = None):
    """Gating only: x (N, D), router_w (D, E), same dtype (float32 or
    bfloat16), E <= 128, k <= min(8, E); experts at or past
    ``valid_experts`` are masked. Returns ``(vals (N, k) f32, idx (N, k)
    i32)``, the weights renormalized to sum 1 and ties to the lowest
    index: the contract of the reference's ``router_topk_pallas``. One
    launch of the fused router's gate kernel."""
    if x.device.type == "cpu" and router_w.device.type == "cpu":
        return router_topk_ref(x, router_w, k=k, valid_experts=valid_experts)
    what = "router_topk"
    code = _check_args(what, x, router_w, k)
    N, D = x.shape
    E = router_w.shape[1]
    ve = E if valid_experts is None else int(valid_experts)
    vals = torch.empty((N, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=x.device)
    lib = _lib()
    status = lib.router_topk(ptr(x), ptr(router_w), code, N, D, E, k, ve,
                             ptr(vals), ptr(idx), stream_ptr(x.device))
    _build.check(lib, status, what)
    router_topk.launches += 1
    return vals, idx


def router_topk_fused(x: torch.Tensor, router_w: torch.Tensor, *, k: int,
                      valid_experts: Optional[int] = None):
    """One-pass routing + dispatch metadata.

    x (N, D), router_w (D, E), same dtype (float32 or bfloat16), E <= 128,
    k <= min(8, E). Returns ``(vals (N, k) f32, idx (N, k) i32,
    pos_in_e (N, k) i32, counts (E,) i32, probs_sum (E,) f32,
    z_sq_sum () f32)``: the contract of the reference's
    ``router_topk_fused_pallas``.
    """
    if x.device.type == "cpu" and router_w.device.type == "cpu":
        return router_topk_fused_ref(x, router_w, k=k,
                                     valid_experts=valid_experts)
    what = "router_topk_fused"
    code = _check_args(what, x, router_w, k)
    N, D = x.shape
    E = router_w.shape[1]
    ve = E if valid_experts is None else int(valid_experts)
    dev = x.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ntiles = -(-N // TILE_TOKENS)
    vals = torch.empty((N, k), **f32)
    idx = torch.empty((N, k), **i32)
    pos = torch.empty((N, k), **i32)
    counts = torch.empty((E,), **i32)
    stats = torch.empty((2, E), **f32)
    probs = torch.empty((N, E), **f32)
    lse2 = torch.empty((N,), **f32)
    tile_counts = torch.empty((ntiles, E), **i32)
    tile_prob = torch.empty((ntiles, E), **f32)
    tile_z = torch.empty((ntiles,), **f32)
    lib = _lib()
    status = lib.router_topk_fused(
        ptr(x), ptr(router_w), code, N, D, E, k, ve, ptr(vals), ptr(idx),
        ptr(pos), ptr(counts), ptr(stats), ptr(probs), ptr(lse2),
        ptr(tile_counts), ptr(tile_prob), ptr(tile_z), stream_ptr(dev))
    _build.check(lib, status, what)
    router_topk_fused.launches += 1
    return vals, idx, pos, counts, stats[0], stats[1, 0]


router_topk_fused.launches = 0
router_topk.launches = 0
