"""Prompt prefix cache: reuse prepared KV state across requests.

A copy of ``repro.serving.prefix_cache`` (numpy only): the port imports
nothing of the reference package.

Shared-prompt traffic (few-shot templates, system prompts, retry storms)
re-prefills identical token prefixes over and over. This cache keeps the
prepared batch-1 decode caches of recent prompts and serves new requests
from them:

* **exact hit** — the whole prompt was seen before: the stored cache and
  last-token logits are reused as-is (bit-identical to re-prefilling,
  since prefill is deterministic), skipping the prefill entirely.
* **prefix hit** — a stored prompt is a strict prefix of the new one:
  the stored cache is extended by teacher-forcing the remaining prompt
  tokens through the decode path (one step per token), which costs
  O(suffix) instead of O(full prompt) attention rows.

Validity rests on causality: in a causal decoder-only stack, the KV rows
for positions ``< n`` depend only on tokens ``< n``, so a prefix's cache
is exactly the prefix of the full prompt's cache. The engine therefore
refuses to enable the cache for non-causal, encoder-decoder, or
frontend-token models. Entries store the PREPARED (max_len-padded)
decode cache; rows past ``true_len`` hold right-pad garbage that decode
validity masks until real tokens overwrite them — the same invariant the
slot cache already relies on.

Eviction is LRU by entry count (each entry holds a full batch-1 decode
cache, so capacities are small).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np


class PrefixEntry(NamedTuple):
    prompt: np.ndarray        # (S,) int32 token ids
    cache: Any                # prepared batch-1 decode cache (device tree)
    last_logits: np.ndarray   # (vocab,) f32 logits after the last token
    caps: Optional[Dict]      # sliced prefill captures (telemetry replay)


class PrefixCache:
    """LRU store of prepared prompt caches with longest-prefix lookup."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("prefix cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self.exact_hits = 0
        self.prefix_hits = 0
        self.misses = 0
        self.saved_tokens = 0        # prompt tokens NOT re-prefilled

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray
               ) -> Tuple[str, Optional[PrefixEntry]]:
        """Returns ("exact", entry), ("prefix", entry of the LONGEST
        stored strict prefix), or ("miss", None). Updates hit/miss stats
        and LRU recency."""
        prompt = np.asarray(prompt, np.int32).ravel()
        key = prompt.tobytes()
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.exact_hits += 1
            self.saved_tokens += len(prompt)
            return "exact", hit
        best: Optional[PrefixEntry] = None
        for e in self._entries.values():
            n = len(e.prompt)
            if n < len(prompt) and (best is None or n > len(best.prompt)) \
                    and np.array_equal(e.prompt, prompt[:n]):
                best = e
        if best is not None:
            self._entries.move_to_end(best.prompt.tobytes())
            self.prefix_hits += 1
            self.saved_tokens += len(best.prompt)
            return "prefix", best
        self.misses += 1
        return "miss", None

    def put(self, prompt: np.ndarray, cache: Any, last_logits: np.ndarray,
            caps: Optional[Dict] = None) -> None:
        prompt = np.asarray(prompt, np.int32).ravel()
        key = prompt.tobytes()
        self._entries[key] = PrefixEntry(prompt, cache,
                                         np.asarray(last_logits), caps)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        return {"exact_hits": self.exact_hits,
                "prefix_hits": self.prefix_hits,
                "misses": self.misses,
                "saved_tokens": self.saved_tokens,
                "entries": len(self._entries)}
