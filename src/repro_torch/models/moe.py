"""Mixture-of-Experts layer: top-k router + pluggable dispatch executors.

Counterpart of ``repro.models.moe``. One routing front-end feeds three
executors, selected by ``moe_forward(..., executor=...)``:

* ``"dense"``   -- capacity buffers ``(E, C, d)``; overflowing pairs are
  dropped; the expert compute is the capacity FFN kernel
  (``repro_torch.kernels.expert_ffn``: the Hopper kernel for CUDA
  tensors, its plain version for CPU tensors).
* ``"grouped"`` -- dropless ragged grouped FFN over expert-sorted rows in
  block-aligned groups; the expert compute is the grouped kernel
  (``repro_torch.kernels.grouped_moe``: the Hopper kernel for CUDA
  tensors, its plain version for CPU tensors).
* ``"oracle"``  -- every expert on every token, top-k mixed (plain torch).

Routing (``router_impl``):

* ``"fused"``     -- :func:`route_fused`, the fused router kernel
  (``repro_torch.kernels.router_topk``): weights, indices, stable
  within-expert ranks, counts and loss statistics in one call. Replaces
  the reference's ``route_fused`` twin and ``route_fused_pallas``.
* ``"reference"`` -- :func:`route` then the separate argsort / bincount
  passes of :func:`build_dispatch` / :func:`build_grouped_dispatch`.

Integer plans are bit-equal across both front-ends and to the
reference. Indices are int32 as in the reference and become int64 only
to index. Scatters that the reference drops (``mode="drop"``) or fills
(``mode="fill"``) write to / read from one extra sentinel row here.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig, ModelConfig
from repro_torch.kernels.expert_ffn.ops import capacity_ffn
from repro_torch.kernels.grouped_moe.ops import BLOCK_ROWS, grouped_moe_ffn
from repro_torch.kernels.router_topk.ops import router_topk_fused
from repro_torch.kernels.router_topk.ref import masked_logits, topk_lowest_index
from repro_torch.models.common import Params, dense_init, gelu
from repro_torch.models.mlp import init_mlp, mlp_forward

MOE_EXECUTORS = ("dense", "grouped", "oracle")
ROUTER_IMPLS = ("fused", "reference")


def check_router_impl(router_impl: str) -> None:
    if router_impl not in ROUTER_IMPLS:
        hint = (" (the port's fused router kernel is router_impl='fused')"
                if router_impl == "pallas" else "")
        raise ValueError(f"unknown router impl {router_impl!r}; expected one "
                         f"of {ROUTER_IMPLS}{hint}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Tuple[int, ...] = (), *,
             num_experts: Optional[int] = None) -> Params:
    m = cfg.moe
    assert m is not None
    E = num_experts or m.num_experts
    d, ff = cfg.d_model, m.d_expert_ff
    p: Params = {"router": dense_init(gen, lead + (d, E))}
    if cfg.activation == "swiglu":
        p["w_gate"] = dense_init(gen, lead + (E, d, ff))
        p["w_up"] = dense_init(gen, lead + (E, d, ff))
        p["w_down"] = dense_init(gen, lead + (E, ff, d))
    else:
        p["w_in"] = dense_init(gen, lead + (E, d, ff))
        p["w_out"] = dense_init(gen, lead + (E, ff, d))
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(gen, d, m.num_shared_experts * m.shared_ff,
                               cfg.activation, lead)
    return p


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

class RouterOut(NamedTuple):
    topk_idx: torch.Tensor      # (N, k) int32
    topk_weight: torch.Tensor   # (N, k) f32, normalized
    probs: torch.Tensor         # (N, E) f32
    lb_loss: torch.Tensor       # scalar
    z_loss: torch.Tensor        # scalar


def _lb_loss(primary: torch.Tensor, mean_probs: torch.Tensor) -> torch.Tensor:
    """GShard/Switch load balance: E * sum(frac_tokens * frac_probs)."""
    E = mean_probs.shape[-1]
    frac_tokens = F.one_hot(primary.long(), E).float().mean(0)
    return E * (frac_tokens * mean_probs).sum()


def route(router_w: torch.Tensor, x_flat: torch.Tensor, m: MoEConfig,
          valid_experts: Optional[int] = None) -> RouterOut:
    """The separate-pass router (the reference's ``route``)."""
    logits = masked_logits(x_flat, router_w, valid_experts)
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = topk_lowest_index(probs, m.top_k)
    topk_w = topk_w / topk_w.sum(-1, keepdim=True).clamp_min(1e-9)
    lb = _lb_loss(topk_idx[:, 0], probs.mean(0))
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return RouterOut(topk_idx, topk_w, probs, lb, z)


class FusedRouting(NamedTuple):
    """Routing plus the dispatch metadata the executors need, in one pass.

    ``pos_in_e`` is each routed (token, k) pair's stable rank among the
    pairs of its expert in flattened row-major pair order, so capacity
    slots (``idx * C + pos_in_e``) and grouped rows
    (``group_offsets[idx] + pos_in_e``) equal the separate-pass plans.
    """

    topk_idx: torch.Tensor      # (N, k) int32
    topk_weight: torch.Tensor   # (N, k) f32, normalized
    pos_in_e: torch.Tensor      # (N, k) int32
    expert_counts: torch.Tensor  # (E,) int32
    lb_loss: torch.Tensor
    z_loss: torch.Tensor


def route_fused(router_w: torch.Tensor, x_flat: torch.Tensor, m: MoEConfig,
                valid_experts: Optional[int] = None) -> FusedRouting:
    """Fused routing through the router kernel (its plain version on the
    CPU). Integers are exact; the losses come from the kernel's per-expert
    prob mass and sum of logsumexp^2."""
    E = router_w.shape[-1]
    N = x_flat.shape[0]
    vals, idx, pos, counts, probs_sum, z_sq = router_topk_fused(
        x_flat, router_w, k=m.top_k, valid_experts=valid_experts)
    lb = _lb_loss(idx[:, 0], probs_sum / N)
    return FusedRouting(idx, vals, pos, counts, lb, z_sq / N)


# ---------------------------------------------------------------------------
# Capacity-buffer dispatch plan
# ---------------------------------------------------------------------------

class DispatchPlan(NamedTuple):
    """Scatter/gather indices mapping (token, k)-slots <-> capacity buffers."""

    buffer_index: torch.Tensor   # (N*k,) int32 flat index into (E*C); E*C if dropped
    token_index: torch.Tensor    # (N*k,) int32 source token of each sorted slot
    slot_of_pair: torch.Tensor   # (N, k) int32 flat buffer index per pair
    kept: torch.Tensor           # (N, k) bool
    expert_counts: torch.Tensor  # (E,) int32 pre-drop routed counts
    capacity: int


def capacity_for(n_tokens: int, m: MoEConfig, num_experts: int,
                 multiple: int = 8) -> int:
    """Per-expert buffer rows: ceil(n * k * capacity_factor / E) in exact
    rational arithmetic, rounded up to ``multiple``."""
    cf = Fraction(m.capacity_factor).limit_denominator(1 << 16)
    c = max(1, math.ceil(Fraction(n_tokens * m.top_k) * cf / num_experts))
    return ((c + multiple - 1) // multiple) * multiple


class RoutingSummary(NamedTuple):
    """What an executor did with the routed (token, k) pairs."""

    expert_counts: torch.Tensor  # (E,) int32 routed pair counts (pre-drop)
    kept_counts: torch.Tensor    # (E,) int32 pairs actually computed
    dropped: torch.Tensor        # (E,) int32 pairs dropped by capacity
    drop_mask: torch.Tensor      # (N, k) bool
    group_offsets: torch.Tensor  # (E,) int32 first buffer row of each expert
    capacity: torch.Tensor       # () int32 per-expert capacity (0 = dropless)


def _exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def build_dispatch(topk_idx: torch.Tensor, num_experts: int,
                   capacity: int) -> DispatchPlan:
    N, k = topk_idx.shape
    E, C = num_experts, capacity
    dev = topk_idx.device
    flat_e = topk_idx.reshape(N * k).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    pos_in_e = torch.arange(N * k, device=dev) - _exclusive_cumsum(counts)[sorted_e]
    kept_sorted = pos_in_e < C
    buffer_index = torch.where(kept_sorted, sorted_e * C + pos_in_e,
                               torch.full_like(pos_in_e, E * C))
    slot_of_flat = torch.zeros(N * k, dtype=torch.int32, device=dev)
    slot_of_flat[order] = buffer_index.to(torch.int32)
    kept_of_flat = torch.zeros(N * k, dtype=torch.bool, device=dev)
    kept_of_flat[order] = kept_sorted
    return DispatchPlan(
        buffer_index=buffer_index.to(torch.int32),
        token_index=(order // k).to(torch.int32),
        slot_of_pair=slot_of_flat.reshape(N, k),
        kept=kept_of_flat.reshape(N, k),
        expert_counts=counts.to(torch.int32),
        capacity=C,
    )


def dispatch_plan_from_fused(fr: FusedRouting, num_experts: int,
                             capacity: int) -> DispatchPlan:
    """Capacity-buffer plan straight from fused routing (no argsort)."""
    N, k = fr.topk_idx.shape
    E, C = num_experts, capacity
    kept = fr.pos_in_e < C
    slot = torch.where(kept, fr.topk_idx * C + fr.pos_in_e,
                       torch.full_like(fr.pos_in_e, E * C)).to(torch.int32)
    return DispatchPlan(
        buffer_index=slot.reshape(N * k),
        token_index=(torch.arange(N * k, dtype=torch.int32,
                                  device=slot.device) // k),
        slot_of_pair=slot,
        kept=kept,
        expert_counts=fr.expert_counts,
        capacity=C,
    )


def dispatch_tokens(x_flat: torch.Tensor, plan: DispatchPlan,
                    num_experts: int) -> torch.Tensor:
    """Scatter tokens into (E, C, d) capacity buffers; dropped pairs land
    on a sentinel row that is cut off (the reference's ``mode="drop"``)."""
    E, C, d = num_experts, plan.capacity, x_flat.shape[-1]
    buf = x_flat.new_zeros((E * C + 1, d))
    buf[plan.buffer_index.long()] = x_flat[plan.token_index.long()]
    return buf[:E * C].reshape(E, C, d)


def combine_tokens(buf_out: torch.Tensor, plan: DispatchPlan,
                   topk_weight: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs back to (N, d), weighted by router probs;
    the sentinel slot reads a zero row (the reference's ``mode="fill"``)."""
    E, C, d = buf_out.shape
    flat = torch.cat([buf_out.reshape(E * C, d), buf_out.new_zeros((1, d))])
    gathered = flat[plan.slot_of_pair.long()]
    w = torch.where(plan.kept, topk_weight, torch.zeros_like(topk_weight))
    return torch.einsum("nkd,nk->nd", gathered, w.to(gathered.dtype))


# ---------------------------------------------------------------------------
# Grouped (dropless) dispatch: sorted block-aligned ragged groups
# ---------------------------------------------------------------------------

class GroupedDispatch(NamedTuple):
    """Sorted ragged-group layout for the dropless grouped path."""

    row_of_pair: torch.Tensor    # (N, k) int32 destination row per pair
    tile_expert: torch.Tensor    # (T,) int32 expert owning each row tile
    group_offsets: torch.Tensor  # (E,) int32 first row of each expert group
    expert_counts: torch.Tensor  # (E,) int32 routed pair counts
    block_rows: int
    num_rows: int                # static padded row count R (T * block_rows)


def grouped_rows_for(n_pairs: int, num_experts: int, block_rows: int = 8,
                     multiple: int = 1) -> int:
    """Static worst-case sorted-buffer rows: every routed pair plus up to
    ``block_rows - 1`` padding rows per active expert, tile-aligned."""
    active = min(num_experts, n_pairs)
    worst = n_pairs + active * (block_rows - 1)
    step = block_rows * max(1, multiple)
    return ((worst + step - 1) // step) * step


def _group_layout(counts: torch.Tensor, n_pairs: int, num_experts: int,
                  block_rows: int, row_multiple: int):
    """(offsets, tile_expert, R) from per-expert counts."""
    padded = ((counts + block_rows - 1) // block_rows) * block_rows
    ends = torch.cumsum(padded, 0)
    offsets = ends - padded
    R = grouped_rows_for(n_pairs, num_experts, block_rows, row_multiple)
    tile_start = torch.arange(R // block_rows, device=counts.device) * block_rows
    tile_expert = torch.searchsorted(ends, tile_start, right=True).clamp(
        0, num_experts - 1)
    return offsets, tile_expert.to(torch.int32), R


def build_grouped_dispatch(topk_idx: torch.Tensor, num_experts: int, *,
                           block_rows: int = 8,
                           row_multiple: int = 1) -> GroupedDispatch:
    """Sort (token, k) pairs by expert into block-aligned ragged groups
    with a stable argsort (the separate-pass layout)."""
    N, k = topk_idx.shape
    E = num_experts
    dev = topk_idx.device
    flat_e = topk_idx.reshape(N * k).long()
    counts = torch.bincount(flat_e, minlength=E)
    offsets, tile_expert, R = _group_layout(counts, N * k, E, block_rows,
                                            row_multiple)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = torch.arange(N * k, device=dev) - _exclusive_cumsum(counts)[sorted_e]
    row_of_flat = torch.zeros(N * k, dtype=torch.int32, device=dev)
    row_of_flat[order] = (offsets[sorted_e] + pos_in_e).to(torch.int32)
    return GroupedDispatch(
        row_of_pair=row_of_flat.reshape(N, k),
        tile_expert=tile_expert,
        group_offsets=offsets.to(torch.int32),
        expert_counts=counts.to(torch.int32),
        block_rows=block_rows,
        num_rows=R,
    )


def grouped_dispatch_from_fused(fr: FusedRouting, num_experts: int, *,
                                block_rows: int = 8,
                                row_multiple: int = 1) -> GroupedDispatch:
    """Block-aligned ragged-group layout straight from fused routing:
    the row of a pair is ``group_offsets[expert] + rank``."""
    N, k = fr.topk_idx.shape
    counts = fr.expert_counts.long()
    offsets, tile_expert, R = _group_layout(counts, N * k, num_experts,
                                            block_rows, row_multiple)
    row_of_pair = offsets[fr.topk_idx.long()] + fr.pos_in_e
    return GroupedDispatch(
        row_of_pair=row_of_pair.to(torch.int32),
        tile_expert=tile_expert,
        group_offsets=offsets.to(torch.int32),
        expert_counts=fr.expert_counts.to(torch.int32),
        block_rows=block_rows,
        num_rows=R,
    )


def dispatch_grouped(x_flat: torch.Tensor,
                     gd: GroupedDispatch) -> torch.Tensor:
    """Scatter tokens into the sorted (R, d) ragged-group buffer."""
    N, k = gd.row_of_pair.shape
    tok = torch.arange(N * k, device=x_flat.device) // k
    buf = x_flat.new_zeros((gd.num_rows, x_flat.shape[-1]))
    buf[gd.row_of_pair.reshape(-1).long()] = x_flat[tok]
    return buf


def combine_grouped(buf_out: torch.Tensor, gd: GroupedDispatch,
                    topk_weight: torch.Tensor) -> torch.Tensor:
    """Gather every pair's expert output (dropless) and mix by weight."""
    g = buf_out[gd.row_of_pair.long()]                 # (N, k, d)
    return torch.einsum("nkd,nk->nd", g, topk_weight.to(g.dtype))


def grouped_expert_ffn(params: Params, buf: torch.Tensor,
                       tile_expert: torch.Tensor,
                       activation: str) -> torch.Tensor:
    """The grouped expert FFN through the grouped kernel's wrapper."""
    if activation == "swiglu":
        return grouped_moe_ffn(buf, tile_expert, params["w_gate"],
                               params["w_up"], params["w_down"],
                               activation="swiglu")
    return grouped_moe_ffn(buf, tile_expert, params["w_in"], None,
                           params["w_out"], activation="gelu")


# ---------------------------------------------------------------------------
# Expert FFN on capacity buffers (kernel) / every expert (plain torch)
# ---------------------------------------------------------------------------

def expert_ffn(params: Params, buf: torch.Tensor,
               activation: str) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through the capacity FFN kernel's
    wrapper."""
    if activation == "swiglu":
        return capacity_ffn(buf, params["w_gate"], params["w_up"],
                            params["w_down"], activation="swiglu")
    return capacity_ffn(buf, params["w_in"], None, params["w_out"],
                        activation="gelu")


def _all_experts_out(params: Params, activation: str,
                     x_flat: torch.Tensor) -> torch.Tensor:
    """(E, N, d): every expert applied to every token."""
    if activation == "swiglu":
        g = torch.einsum("nd,edf->enf", x_flat, params["w_gate"])
        u = torch.einsum("nd,edf->enf", x_flat, params["w_up"])
        return torch.einsum("enf,efd->end", F.silu(g) * u, params["w_down"])
    h = gelu(torch.einsum("nd,edf->enf", x_flat, params["w_in"]))
    return torch.einsum("enf,efd->end", h, params["w_out"])


def _dropless_summary(counts: torch.Tensor, drop_mask_shape: Tuple[int, int],
                      group_offsets: torch.Tensor) -> RoutingSummary:
    return RoutingSummary(
        expert_counts=counts,
        kept_counts=counts,
        dropped=torch.zeros_like(counts),
        drop_mask=torch.zeros(drop_mask_shape, dtype=torch.bool,
                              device=counts.device),
        group_offsets=group_offsets.to(torch.int32),
        capacity=torch.zeros((), dtype=torch.int32, device=counts.device),
    )


# ---------------------------------------------------------------------------
# Full layer
# ---------------------------------------------------------------------------

def moe_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                executor: str = "dense", capture: bool = False,
                router_impl: str = "fused"
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Local MoE layer. x: (B, S, d). Returns (y, aux); ``aux["routing"]``
    always carries the executor's :class:`RoutingSummary`. The grouped
    layout uses the grouped kernel's row tile (``BLOCK_ROWS`` = 8, the
    reference's serving default), so ``group_offsets`` equal the
    reference's."""
    m = cfg.moe
    assert m is not None
    if executor not in MOE_EXECUTORS:
        raise ValueError(f"unknown MoE executor {executor!r}; "
                         f"expected one of {MOE_EXECUTORS}")
    check_router_impl(router_impl)
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    if router_impl == "reference":
        r = route(params["router"], x_flat, m, valid_experts=m.num_experts)
        fr = None
    else:
        r = fr = route_fused(params["router"], x_flat, m,
                             valid_experts=m.num_experts)
    E = params["router"].shape[-1]

    if executor == "dense":
        C = capacity_for(B * S, m, E)
        plan = (build_dispatch(r.topk_idx, E, C) if fr is None
                else dispatch_plan_from_fused(fr, E, C))
        buf_out = expert_ffn(params, dispatch_tokens(x_flat, plan, E),
                             cfg.activation)
        y = combine_tokens(buf_out, plan, r.topk_weight)
        counts = plan.expert_counts
        kept = torch.clamp(counts, max=C)
        summary = RoutingSummary(
            expert_counts=counts,
            kept_counts=kept,
            dropped=counts - kept,
            drop_mask=~plan.kept,
            group_offsets=torch.arange(E, dtype=torch.int32,
                                       device=x.device) * C,
            capacity=torch.tensor(C, dtype=torch.int32, device=x.device),
        )
    elif executor == "grouped":
        gd = (build_grouped_dispatch(r.topk_idx, E, block_rows=BLOCK_ROWS)
              if fr is None else
              grouped_dispatch_from_fused(fr, E, block_rows=BLOCK_ROWS))
        buf = dispatch_grouped(x_flat, gd)
        buf_out = grouped_expert_ffn(params, buf, gd.tile_expert,
                                     cfg.activation)
        y = combine_grouped(buf_out, gd, r.topk_weight)
        summary = _dropless_summary(gd.expert_counts, (B * S, m.top_k),
                                    gd.group_offsets)
    else:  # oracle
        all_out = _all_experts_out(params, cfg.activation, x_flat)
        sel = torch.take_along_dim(all_out.movedim(0, 1),
                                   r.topk_idx.long()[..., None], dim=1)
        y = torch.einsum("nkd,nk->nd", sel, r.topk_weight.to(sel.dtype))
        counts = (torch.bincount(r.topk_idx.reshape(-1).long(),
                                 minlength=E).to(torch.int32)
                  if fr is None else fr.expert_counts)
        summary = _dropless_summary(counts, (B * S, m.top_k),
                                    _exclusive_cumsum(counts))

    if m.num_shared_experts > 0:
        y = y + mlp_forward(params["shared"], x_flat, cfg.activation)
    aux: Dict[str, object] = {
        "lb_loss": r.lb_loss * m.router_aux_coef,
        "z_loss": r.z_loss * m.router_z_coef,
        "expert_counts": summary.expert_counts,
        "routing": summary,
    }
    if capture:
        aux["topk_idx"] = r.topk_idx.reshape(B, S, m.top_k)
        aux["topk_weight"] = r.topk_weight.reshape(B, S, m.top_k)
    return y.reshape(B, S, d).to(x.dtype), aux
