"""Plain PyTorch version of GQA flash-decode (what
``csrc/decode_attention.cu`` computes)."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """q (B, N, G, D); k, v (B, T, N, D); valid_len (B,) int.

    Softmax over the first ``valid_len[b]`` cache slots in float32, scale
    D^-1/2, output ``acc / max(l, 1e-30)`` in q's dtype. Masked scores
    are -1e30, as in the Pallas kernel, so a row with no valid slot
    weighs all T slots alike and gives the mean of V over them.
    """
    B, N, G, D = q.shape
    T = k.shape[1]
    scores = torch.einsum("bngd,btnd->bngt", q.float(), k.float()) * (D ** -0.5)
    mask = (torch.arange(T, device=q.device)[None, :]
            < valid_len.to(q.device)[:, None])[:, None, None, :]
    scores = scores.masked_fill(~mask, -1e30)
    m = scores.max(-1, keepdim=True).values
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bngt,btnd->bngd", p, v.float()) / l.clamp_min(1e-30)
    return out.to(q.dtype)
