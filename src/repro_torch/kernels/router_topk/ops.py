"""Wrappers of the router kernels (``csrc/router_topk.cu``): the fused
router (B1) and the gating-only router (B5).

For CPU tensors they return the plain versions (:mod:`.ref`); for CUDA
tensors they launch the kernel or raise. ``router_topk_fused.launches``
and ``router_topk.launches`` count kernel launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (INT, PTR, cdiv, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype, sm_count,
                                         stream_ptr, ticket_workspace)
from repro_torch.kernels.router_topk.ref import (router_topk_fused_ref,
                                                 router_topk_ref)

MAX_EXPERTS, MAX_K = 128, 8    # csrc/router_topk.cu
MAX_TILE = 64                  # tokens per tile
LG_FLOATS = 4096               # a tile's logits in shared memory: tile x E4
DC = 32                        # fewest rows of D a slice takes
MAX_SLICES = 32                # the last block of a tile merges them all


class RouterPlan(NamedTuple):
    """Grid of the one launch: ``tile`` tokens per tile (a multiple of 4)
    and ``slices`` slices of D of ``slice_len`` rows (a multiple of DC)."""

    tile: int
    slices: int
    slice_len: int

    def ntiles(self, N: int) -> int:
        return cdiv(N, self.tile)


def router_plan(N: int, D: int, E: int, sms: int) -> RouterPlan:
    """Tiles of up to 64 tokens (32 when E > 64, so a tile's logits fit in
    shared memory); then enough slices of D for about one block per SM,
    each at least DC rows, at most MAX_SLICES. Few tokens: one tile, W
    spread over up to MAX_SLICES blocks. Many tokens: tiles fill the card
    and slices stay few."""
    E4 = cdiv(E, 4) * 4
    tile = min(MAX_TILE, LG_FLOATS // E4, cdiv(N, 4) * 4)
    slices = max(1, min(cdiv(D, DC), MAX_SLICES, sms // cdiv(N, tile)))
    slice_len = cdiv(cdiv(D, slices), DC) * DC
    return RouterPlan(tile, cdiv(D, slice_len), slice_len)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("router_topk")
    lib.router_topk_fused.argtypes = [PTR, PTR] + [INT] * 9 + [PTR] * 11
    lib.router_topk_fused.restype = INT
    lib.router_topk.argtypes = [PTR, PTR] + [INT] * 9 + [PTR] * 5
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


def _part_floats(plan: RouterPlan, N: int, E: int) -> int:
    """float32 slots of the float64 partial logits (slices > 1 only)."""
    return 2 * plan.slices * N * E if plan.slices > 1 else 0


def _carve(buf: torch.Tensor, sizes):
    """Consecutive 1-D views of ``buf`` (float32) of the given sizes."""
    views, at = [], 0
    for n in sizes:
        views.append(buf[at:at + n])
        at += n
    return views


def router_topk(x: torch.Tensor, router_w: torch.Tensor, *, k: int,
                valid_experts: Optional[int] = None):
    """Gating only: x (N, D), router_w (D, E), same dtype (float32 or
    bfloat16), E <= 128, k <= min(8, E); experts at or past
    ``valid_experts`` are masked. Returns ``(vals (N, k) f32, idx (N, k)
    i32)``, the weights renormalized to sum 1 and ties to the lowest
    index: the contract of the reference's ``router_topk_pallas``. One
    launch of the fused router's kernel, without ranks, counts and
    statistics."""
    if x.device.type == "cpu" and router_w.device.type == "cpu":
        return router_topk_ref(x, router_w, k=k, valid_experts=valid_experts)
    what = "router_topk"
    code = _check_args(what, x, router_w, k)
    N, D = x.shape
    E = router_w.shape[1]
    ve = E if valid_experts is None else int(valid_experts)
    plan = router_plan(N, D, E, sm_count(x.device))
    buf = torch.empty(_part_floats(plan, N, E) + 2 * N * k,
                      dtype=torch.float32, device=x.device)
    part, vals, idx = _carve(buf, (_part_floats(plan, N, E), N * k, N * k))
    idx = idx.view(torch.int32)
    tickets = ticket_workspace(x.device, 1 + plan.ntiles(N))
    lib = _lib()
    status = lib.router_topk(ptr(x), ptr(router_w), code, N, D, E, k, ve,
                             *plan, ptr(vals), ptr(idx), ptr(part),
                             ptr(tickets), stream_ptr(x.device))
    _build.check(lib, status, what)
    router_topk.launches += 1
    return vals.view(N, k), idx.view(N, k)


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
    plan = router_plan(N, D, E, sm_count(dev))
    nt = plan.ntiles(N)
    tile_n = nt * E if nt > 1 else 0
    # one allocation: the float64 partial logits first (8-byte aligned),
    # the outputs, then the per-tile scratch, in 4-byte elements
    sizes = (_part_floats(plan, N, E), N * k, N * k, N * k, E, E + 1,
             tile_n, tile_n, nt if nt > 1 else 0)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    part, vals, idx, pos, counts, stats, tile_counts, tile_prob, tile_z = \
        _carve(buf, sizes)
    idx, pos, counts, tile_counts = (t.view(torch.int32) for t in
                                     (idx, pos, counts, tile_counts))
    tickets = ticket_workspace(dev, 1 + nt)
    lib = _lib()
    status = lib.router_topk_fused(
        ptr(x), ptr(router_w), code, N, D, E, k, ve, *plan, ptr(vals),
        ptr(idx), ptr(pos), ptr(counts), ptr(stats), ptr(part),
        ptr(tile_counts), ptr(tile_prob), ptr(tile_z), ptr(tickets),
        stream_ptr(dev))
    _build.check(lib, status, what)
    router_topk_fused.launches += 1
    return (vals.view(N, k), idx.view(N, k), pos.view(N, k), counts,
            stats[:E], stats[E])


router_topk_fused.launches = 0
router_topk.launches = 0
