"""Wrapper of the grouped expert FFN kernel (``csrc/grouped_moe.cu``) and
its launch plan.

For CPU tensors it returns the plain version (:mod:`.ref`); for CUDA
tensors it launches the kernel or raises. ``grouped_moe_ffn.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (INT, PTR, cdiv, dtype_code, ptr,
                                         require_contiguous, require_cuda,
                                         require_same_dtype,
                                         scratch_workspace, sm_count,
                                         stream_ptr)
from repro_torch.kernels.grouped_moe.ref import grouped_moe_ref

BLOCK_ROWS = 8        # row-tile height the kernel takes (csrc/grouped_moe.cu)
MAX_CLUSTER = 8       # blocks of one cluster: the K splits of a tile
SMEM_LIMIT = 232448   # shared memory one block may use on the H100
# the short path (csrc/grouped_moe.cu)
SHORT_THREADS = 128   # 4 warps: across the columns, then the slice's rows
RING_STAGES = 6       # each thread's cp.async ring
STAGE_ROWS = 4        # weight rows x matrices a thread copies a stage
RING_BYTES = RING_STAGES * STAGE_ROWS * SHORT_THREADS * 16
MAX_SLICE = 768       # K rows a short block stages (8 rows of float32)
MIN_SLICE = 32        # fewest K rows a split takes
BLOCKS_PER_SM = 2     # the short path's target of live blocks per SM
# the long path (csrc/ffn_wgmma.cuh): stages of its TMA ring
WGMMA_STAGES = 4
# mean rows per expert (R / min(E, R / 8)) from which the tensor cores
# take the products
LONG_ROWS = 32


class Product(NamedTuple):
    """One launch (the up or the down product: K rows of weights reduced,
    N columns out). Grid (splits, row_blocks, col_blocks); the splits of a
    column block are one cluster."""

    threads: int
    cols: int            # columns of a block
    col_blocks: int
    row_blocks: int      # short: row tiles; long: slabs the grid covers
    splits: int          # K slices = cluster size
    slice: int           # K rows of a slice
    rows_per_stage: int  # K rows of one ring stage
    stages: int          # ring stages
    smem: int            # dynamic shared memory of a block, bytes


class GroupedPlan(NamedTuple):
    path: str            # "short" (CUDA cores) or "long" (tensor cores)
    up: Product
    down: Product
    work_floats: int     # float32 workspace: h (R x F), a mask per tile

    def ints(self) -> list:
        return [0 if self.path == "short" else 1, *self.up, *self.down]


def _pow2_at_least(n: int) -> int:
    """The smallest power of two >= n (clusters of 1, 2, 4 or 8 blocks
    ran faster on the H100 than clusters of 3, 5 or 6 at the same work)."""
    return 1 << max(0, n - 1).bit_length()


def _short_product(K: int, N: int, ntiles: int, elem: int, mats: int,
                   sms: int) -> Product:
    """16 bytes of columns a thread; the block's 4 warps side by side
    across the columns, or (fewer columns) also across the slice's rows:
    the widest block that still gives BLOCKS_PER_SM blocks per SM with a
    full cluster. Then K split into enough slices for that, each a whole
    number of the block's ring stages and at most MAX_SLICE rows."""
    vec = 16 // elem
    for warps in (4, 2, 1):
        cols = 32 * vec * warps
        units = ntiles * cdiv(N, cols)
        if units * MAX_CLUSTER >= BLOCKS_PER_SM * sms:
            break
    splits = _pow2_at_least(max(cdiv(K, MAX_SLICE), min(
        MAX_CLUSTER, cdiv(K, MIN_SLICE), cdiv(BLOCKS_PER_SM * sms, units))))
    groups = SHORT_THREADS * vec // cols
    step = STAGE_ROWS // mats * groups   # the block's K rows of one stage
    slice_ = cdiv(cdiv(K, splits), step) * step
    if slice_ > MAX_SLICE:
        slice_ = MAX_SLICE // step * step
    if cdiv(K, slice_) > MAX_CLUSTER:
        raise ValueError(f"grouped_moe_ffn: K={K} needs more than "
                         f"{MAX_CLUSTER} slices of {slice_} rows")
    smem = max(RING_BYTES + BLOCK_ROWS * slice_ * 4,
               groups * mats * BLOCK_ROWS * cols * 4)
    return Product(SHORT_THREADS, cols, cdiv(N, cols), ntiles,
                   cdiv(K, slice_), slice_, step, RING_STAGES, smem)


def _wgmma_smem(mode: str, mats: int) -> tuple:
    """(BN, BK, shared memory) of the tensor-core tile (ffn_wgmma.cuh,
    Tile::smem with one warpgroup): ``mode`` 3xtf32 (float32 A and B),
    2xtf32 (float32 A, bfloat16 B) or bf16."""
    bn = 64 if mats == 2 else 128
    ope = 2 if mode == "bf16" else 4            # A operand bytes
    bk = 128 // ope
    parts = 2 if mode == "3xtf32" else 1        # B hi (+ lo)
    tb = 4 if mode == "3xtf32" else 2           # B bytes
    ops = 2 * mats * parts * bn * 128
    return bn, bk, 1024 + ops + WGMMA_STAGES * (64 * 128 + mats * bk * bn * tb)


def _long_product(K: int, N: int, R: int, E: int, mode: str, mats: int,
                  sms: int) -> Product:
    """64-row slabs by BN-column tiles; K split (one cluster of 1, 2, 4 or
    8 blocks) as far as the blocks still fit the card about once, for the
    slabs the layout has when the rows spread evenly over min(E, R / 8)
    experts."""
    bn, bk, smem = _wgmma_smem(mode, mats)
    ntiles = R // BLOCK_ROWS
    experts = min(E, ntiles)
    slabs = experts * cdiv(cdiv(ntiles, experts), 8)
    tiles = slabs * cdiv(N, bn)
    slots = sms * max(1, SMEM_LIMIT // (smem + 1024))
    kt = cdiv(K, bk)
    splits = 1
    while (splits * 2 <= min(MAX_CLUSTER, kt)
           and tiles * splits * 2 <= slots + slots // 8):
        splits *= 2
    per = cdiv(kt, splits)
    # a row of blocks per slab when each expert's tiles form one run
    row_blocks = cdiv(ntiles, 8) + experts
    return Product(128, bn, cdiv(N, bn), row_blocks, cdiv(kt, per),
                   per * bk, bk, WGMMA_STAGES, smem)


def grouped_plan(R: int, D: int, F: int, E: int, dtype: torch.dtype,
                 swiglu: bool, sms: int) -> GroupedPlan:
    """The launch plan of the grouped FFN from static shapes alone (it
    reads no tensor): R rows (8-row tiles), widths D and F, E experts,
    float32 or bfloat16, SwiGLU (two up matrices) or GELU, and the card's
    SM count. The tensor cores take the products when the mean rows per
    expert, R / min(E, R / 8), reach LONG_ROWS and the rows are whole
    16-byte chunks (their tensor maps need that); otherwise the short
    path streams the weights on the CUDA cores."""
    elem = 4 if dtype == torch.float32 else 2
    ntiles = R // BLOCK_ROWS
    mats = 2 if swiglu else 1
    mean_rows = R / min(E, ntiles)
    aligned = (D * elem) % 16 == 0 and (F * elem) % 16 == 0
    if mean_rows >= LONG_ROWS and aligned:
        up_mode = "3xtf32" if elem == 4 else "bf16"
        down_mode = "3xtf32" if elem == 4 else "2xtf32"
        up = _long_product(D, F, R, E, up_mode, mats, sms)
        down = _long_product(F, D, R, E, down_mode, 1, sms)
        path = "long"
    else:
        up = _short_product(D, F, ntiles, elem, mats, sms)
        down = _short_product(F, D, ntiles, elem, 1, sms)
        path = "short"
    return GroupedPlan(path, up, down, cdiv(R * F + ntiles, 4) * 4)


PLAN_INTS = 19


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("grouped_moe")
    lib.grouped_moe_ffn.argtypes = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                    INT, INT, PTR, PTR, PTR, PTR]
    lib.grouped_moe_ffn.restype = INT
    lib.grouped_moe_plan_ints.restype = INT
    if lib.grouped_moe_plan_ints() != PLAN_INTS:
        raise RuntimeError("grouped_moe: the library's plan layout differs")
    return lib


@functools.lru_cache(maxsize=None)
def _plan_ints(R, D, F, E, dtype, swiglu, sms):
    plan = grouped_plan(R, D, F, E, dtype, swiglu, sms)
    return plan, (ctypes.c_int * PLAN_INTS)(*plan.ints())


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
    dev = x_sorted.device
    plan, ints = _plan_ints(R, D, F, E, x_sorted.dtype, w_up is not None,
                            sm_count(dev))
    work = scratch_workspace(dev, plan.work_floats)
    out = torch.empty_like(x_sorted)
    status = lib.grouped_moe_ffn(
        ptr(x_sorted), ptr(tile_expert), ptr(w_gate),
        ptr(w_up) if w_up is not None else None, ptr(w_down), code, nt, D, F,
        E, ints, ptr(work), ptr(out), stream_ptr(dev))
    _build.check(lib, status, what)
    grouped_moe_ffn.launches += 1
    return out


grouped_moe_ffn.launches = 0
