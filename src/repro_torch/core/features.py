"""Token feature extraction (paper §III-B).

A copy of ``repro.core.features`` (numpy only): the port imports
nothing of the reference package.

Features per token per MoE layer: f1 = token ID, f2 = position ID,
f3 = attention ID -- the token ID of the sequence position with the highest
summed softmax attention score across all heads of the multi-head attention
immediately preceding the MoE layer.

``extract_features`` consumes the ``capture`` output of a real model run
(``Model.forward(..., capture=True)``) and flattens it into per-MoE-layer
records of (f1, f2, f3, routed experts).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class LayerRecords:
    """Flattened routing observations for one MoE layer."""

    layer: int
    token_id: np.ndarray     # (N,) f1
    position: np.ndarray     # (N,) f2
    attention_id: np.ndarray  # (N,) f3
    experts: np.ndarray      # (N, k) routed experts (ground truth)
    weights: np.ndarray      # (N, k)


def extract_features(tokens: np.ndarray, captures: Dict,
                     pattern_len: int) -> List[LayerRecords]:
    """tokens: (B, S) int. ``captures``: aux["captures"] from Model.forward.

    Captured arrays are stacked (num_blocks, B, S, ...) per unit position;
    global MoE layer index = block * pattern_len + position_in_pattern.
    """
    tokens = np.asarray(tokens)
    B, S = tokens.shape
    out: List[LayerRecords] = []
    pos_ids = np.broadcast_to(np.arange(S), (B, S))
    for p in range(pattern_len):
        cap = captures.get(f"pos{p}", {})
        if "topk_idx" not in cap:
            continue
        topk = np.asarray(cap["topk_idx"])          # (nb, B, S, k)
        w = np.asarray(cap["topk_weight"])
        nb = topk.shape[0]
        if "attn_argmax" in cap:
            am = np.asarray(cap["attn_argmax"])     # (nb, B, S)
        else:
            am = np.broadcast_to(np.arange(S), (nb, B, S))
        for b in range(nb):
            att_pos = np.clip(am[b], 0, S - 1)
            attn_id = np.take_along_axis(tokens, att_pos, axis=1)
            out.append(LayerRecords(
                layer=b * pattern_len + p,
                token_id=tokens.reshape(-1),
                position=pos_ids.reshape(-1),
                attention_id=attn_id.reshape(-1),
                experts=topk[b].reshape(B * S, -1),
                weights=w[b].reshape(B * S, -1),
            ))
    return sorted(out, key=lambda r: r.layer)
