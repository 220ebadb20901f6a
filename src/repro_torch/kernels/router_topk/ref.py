"""Plain PyTorch versions of the router kernels (what
``csrc/router_topk.cu`` computes): the CPU path of the wrappers and the
card's comparison."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def topk_lowest_index(scores: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis by k rounds of max, ties to the LOWEST
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none).
    Returns (values (..., k), int32 indices (..., k))."""
    E = scores.shape[-1]
    col = torch.arange(E, device=scores.device)
    work = scores
    vals, idxs = [], []
    for _ in range(k):
        v = work.max(-1).values
        i = torch.where(work == v[..., None], col, E).min(-1).values
        vals.append(v)
        idxs.append(i)
        work = torch.where(col == i[..., None], torch.full_like(work, -1.0),
                           work)
    return torch.stack(vals, -1), torch.stack(idxs, -1).to(torch.int32)


def masked_logits(x: torch.Tensor, router_w: torch.Tensor,
                  valid_experts: Optional[int]) -> torch.Tensor:
    """float32 ``x @ W`` with experts at or past ``valid_experts`` at -1e9."""
    logits = x.float() @ router_w.float()
    E = logits.shape[-1]
    if valid_experts is not None and valid_experts < E:
        col = torch.arange(E, device=logits.device)
        logits = torch.where(col < valid_experts, logits,
                             torch.full_like(logits, -1e9))
    return logits


def stable_ranks(idx: torch.Tensor, num_experts: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's rank among the pairs of its expert in
    flattened row-major order (a stable argsort's rank), and the
    per-expert pair counts; both int32."""
    N, k = idx.shape
    oh = (idx.reshape(N * k, 1).long()
          == torch.arange(num_experts, device=idx.device)).to(torch.int32)
    csum = torch.cumsum(oh, 0)
    pos = ((csum - oh) * oh).sum(-1).reshape(N, k)
    return pos.to(torch.int32), oh.sum(0).to(torch.int32)


def _gate(x: torch.Tensor, router_w: torch.Tensor, k: int,
          valid_experts: Optional[int]):
    """(probs (N, E), logsumexp (N,), normalized top-k weights, indices)."""
    logits = masked_logits(x, router_w, valid_experts)
    m = logits.max(-1, keepdim=True).values
    p = torch.exp(logits - m)
    psum = p.sum(-1, keepdim=True)
    probs = p / psum
    lse = (m + torch.log(psum))[:, 0]
    vals, idx = topk_lowest_index(probs, k)
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, lse, vals, idx


def router_topk_ref(x: torch.Tensor, router_w: torch.Tensor, *, k: int,
                    valid_experts: Optional[int] = None):
    """Gating only: ``(vals (N, k) f32, idx (N, k) i32)``, the contract of
    the reference's ``router_topk_pallas``."""
    _, _, vals, idx = _gate(x, router_w, k, valid_experts)
    return vals, idx


def router_topk_fused_ref(x: torch.Tensor, router_w: torch.Tensor, *,
                          k: int, valid_experts: Optional[int] = None):
    """Returns ``(vals (N, k) f32, idx (N, k) i32, pos_in_e (N, k) i32,
    counts (E,) i32, probs_sum (E,) f32, z_sq_sum () f32)``."""
    probs, lse, vals, idx = _gate(x, router_w, k, valid_experts)
    pos, counts = stable_ranks(idx, router_w.shape[-1])
    return vals, idx, pos, counts, probs.sum(0), (lse * lse).sum()
