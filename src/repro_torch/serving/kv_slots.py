"""Per-slot KV-cache management for continuous batching.

Counterpart of ``repro.serving.kv_slots``. The engine keeps ONE
slot-batched decode cache (leaves stacked ``(num_blocks, num_slots, ...)``)
alive for its whole life; admitting a request prefills it alone (batch 1,
exact prompt length) and copies the prepared single-request cache into
the free slot's row. The reference does that copy in a jitted scatter
whose cache argument is donated; here it is an in-place slice write, and
the decode step writes its new K/V rows in place as well. Releasing a
slot needs no work: the next admission overwrites the row wholesale.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.params import tree_leaves


class SlotKVCache:
    """Slot-batched decode cache with in-place single-slot insertion.

    Tracks per-slot VALID lengths host-side (``lengths[slot]`` = number of
    cache rows holding real tokens). The ragged-decode path reads
    ``max_valid_len()`` to bound how far batched decode attention must
    scan — everything past the longest live slot is pad by construction.
    """

    def __init__(self, model, num_slots: int, max_len: int):
        self.num_slots = num_slots
        self.max_len = max_len
        self.cache: Dict[str, Any] = model.init_cache(num_slots, max_len)
        self.lengths = np.zeros(num_slots, np.int32)

    def insert(self, prepared_cache: Dict[str, Any], slot: int,
               length: int = 0) -> None:
        """Copy a prepared batch-1 decode cache into ``slot``'s row.

        ``length`` records how many of the row's cache positions hold
        real tokens for ragged-decode bounding."""
        for big, small in zip(tree_leaves(self.cache),
                              tree_leaves(prepared_cache)):
            if small.shape[2:] != big.shape[2:]:
                raise ValueError(f"prepared cache leaf {tuple(small.shape)} "
                                 f"does not fit slot rows {tuple(big.shape)}")
            big[:, slot].copy_(small[:, 0])
        self.lengths[slot] = length

    def set_length(self, slot: int, length: int) -> None:
        self.lengths[slot] = length

    def release(self, slot: int) -> None:
        """Mark a slot's rows as dead (the next insert overwrites them)."""
        self.lengths[slot] = 0

    def max_valid_len(self) -> int:
        """Longest valid row across slots — the ragged-decode bound."""
        return int(self.lengths.max()) if self.num_slots else 0
