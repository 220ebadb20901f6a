"""Streaming Bayesian expert-selection posterior (paper §III-B, online).

A copy of ``repro.predict.online`` (numpy only): the port imports
nothing of the reference package.

The batch :class:`~repro.predict.posterior.ExpertPredictor` refits from a
full :class:`~repro.core.table.KVTable` every time; serving needs the
paper's Eq. 1-2 posterior to track live traffic incrementally. This module
keeps the SUFFICIENT STATISTICS of the posterior —

* joint counts ``S[layer, f1, f3, expert]`` with the position f2 already
  marginalized (Eq. 1 cancels the P'(f2)/P*(f1', f2) factors, so f2 never
  survives into the posterior; keys reuse the table's bit-packing with
  f2 = 0),
* the dataset token-frequency prior ``P'(f)``,
* per-(layer, expert) aggregate routed counts for window-level demand
  forecasting (the trace loop has no token stream),

— and updates them in O(new observations) per ``update()``. Because raw
counts are integer-valued (exact in float64) and the dense posterior is
compiled from the statistics in sorted-key order, streaming N mini-batches
produces a posterior BIT-IDENTICAL to one ``update()`` on the concatenated
data (``tests/test_predict_streaming.py``); against a batch
``ExpertPredictor.fit()`` on the same observations it matches to float
summation-order tolerance (the batch path multiplies P'(f3) before
aggregating over f2, the streaming path after — algebraically equal).

**Sliding-window decay.** ``advance()`` multiplies every statistic by
``decay`` (one call per accounting window), so an observation ``a``
windows old carries weight ``decay**a``: popularity drift stops being
averaged into stale posteriors and the predictor re-converges on the new
regime. ``decay=1.0`` (default) is exactly the paper's grow-only
statistics.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.features import LayerRecords
from repro_torch.core.table import KVTable, pack_key, unpack_key

from repro_torch.predict.posterior import (DENSE_POSTERIOR_LIMIT,
                                           _normalized_rows, dense_predict,
                                           dense_predict_demand,
                                           dense_predict_layers)

# decayed counts below this are dropped from the sparse statistics
_PRUNE_EPS = 1e-12


class OnlinePredictor:
    """Online Eq. 1-2 posterior with streaming updates and decay."""

    def __init__(self, num_layers: int, num_experts: int, vocab_size: int,
                 *, mode: str = "full", top_k: int = 1,
                 decay: float = 1.0, refresh_every: int = 1):
        """``refresh_every``: recompile the dense posterior tensor only
        after this many ``update()``-family calls since the last compile
        (predictions in between serve the previous tensor). 1 (default)
        keeps every prediction exactly fresh; serving hot loops that
        update once per decode step can raise it to amortize the
        O(statistics) compile. ``posteriors()`` always forces a fresh
        compile, so the equivalence contracts are unaffected."""
        assert mode in ("full", "lina"), mode
        assert 0.0 < decay <= 1.0, decay
        assert refresh_every >= 1, refresh_every
        if num_layers * vocab_size * num_experts > DENSE_POSTERIOR_LIMIT:
            raise ValueError(
                f"geometry {num_layers}x{vocab_size}x{num_experts} exceeds "
                f"DENSE_POSTERIOR_LIMIT ({DENSE_POSTERIOR_LIMIT}); the "
                "online predictor keeps a dense posterior tensor")
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.vocab_size = vocab_size
        self.mode = mode
        self.top_k = top_k
        self.decay = decay
        # sparse sufficient statistics: packed (layer, f1, 0, f3, e) -> count
        self._counts: Dict[int, float] = {}
        self.token_freq = np.zeros(vocab_size)
        # window-level aggregates for demand forecasting (no token stream)
        self._agg = np.zeros((num_layers, num_experts))
        self._agg_tokens = 0.0
        self.updates = 0
        self.refresh_every = refresh_every
        self._dirty = True
        self._updates_since_compile = 0
        self._dense: Optional[np.ndarray] = None
        self._prior: Optional[np.ndarray] = None

    def _invalidate(self) -> None:
        self._dirty = True
        self._updates_since_compile += 1

    # ------------------------------------------------------------- updates
    def observe_tokens(self, tokens: np.ndarray) -> None:
        """Fold served/profiled tokens into the frequency prior P'(f)."""
        binc = np.bincount(
            np.clip(np.asarray(tokens, np.int64).ravel(), 0,
                    self.vocab_size - 1), minlength=self.vocab_size)
        self.token_freq = self.token_freq + binc
        if self.mode == "full":      # lina posteriors ignore P'(f3)
            self._invalidate()

    def update(self, tokens: np.ndarray, routes: np.ndarray, *,
               layer: int, attention_ids: Optional[np.ndarray] = None
               ) -> None:
        """Fold one layer's routing observations into the posterior.

        ``tokens``: (N,) f1 token ids; ``routes``: (N,) or (N, k) realized
        expert ids; ``attention_ids``: (N,) f3, defaulting to the token
        itself (the self-attention-ID approximation used when no attention
        capture is available). Equivalent to a full refit on all data seen
        so far — the statistics are additive.
        """
        tokens = np.asarray(tokens, np.int64).ravel()
        routes = np.asarray(routes, np.int64)
        if routes.ndim == 1:
            routes = routes[:, None]
        assert routes.shape[0] == tokens.shape[0], \
            (routes.shape, tokens.shape)
        att = tokens if attention_ids is None \
            else np.asarray(attention_ids, np.int64).ravel()
        for j in range(routes.shape[1]):
            keys = pack_key(layer, tokens, 0, att, routes[:, j])
            uniq, cnt = np.unique(keys, return_counts=True)
            for key, c in zip(uniq.tolist(), cnt.tolist()):
                self._counts[key] = self._counts.get(key, 0.0) + float(c)
        self.updates += 1
        self._invalidate()

    def update_records(self, recs: Iterable[LayerRecords]) -> int:
        """Fold serving-telemetry :class:`LayerRecords` (the exact format
        ``ExpertTelemetry`` captures). Returns the records ingested."""
        n = 0
        for r in recs:
            self.update(r.token_id, r.experts, layer=int(r.layer),
                        attention_ids=r.attention_id)
            n += 1
        return n

    def ingest_table(self, table: KVTable) -> int:
        """Warm-start from an offline-profiled :class:`KVTable` (counts
        marginalized over f2, frequency prior carried over). Returns the
        number of table entries folded in."""
        if table.vocab_size != self.vocab_size:
            raise ValueError(
                f"table vocab ({table.vocab_size}) != predictor vocab "
                f"({self.vocab_size})")
        keys, vals = table.entries()
        if len(keys):
            layer, f1, _, f3, expert = unpack_key(keys)
            merged = pack_key(layer, f1, 0, f3, expert)
            uniq, inv = np.unique(merged, return_inverse=True)
            agg = np.zeros(len(uniq))
            np.add.at(agg, inv, vals)
            for key, c in zip(uniq.tolist(), agg.tolist()):
                self._counts[key] = self._counts.get(key, 0.0) + float(c)
        self.token_freq = self.token_freq + table.token_freq
        self._invalidate()
        return len(keys)

    def update_demand(self, demand: np.ndarray,
                      num_tokens: int) -> None:
        """Fold one accounting window's observed (L, E) routed counts into
        the window-level aggregates ``forecast_demand`` extrapolates."""
        d = np.asarray(demand, float)
        assert d.shape == self._agg.shape, (d.shape, self._agg.shape)
        self._agg = self._agg + d
        self._agg_tokens += float(num_tokens)

    def advance(self, windows: int = 1) -> None:
        """Close ``windows`` accounting windows: every statistic decays by
        ``decay**windows``. A no-op at ``decay=1.0``."""
        if self.decay >= 1.0 or windows <= 0:
            return
        f = self.decay ** windows
        for key in list(self._counts):
            v = self._counts[key] * f
            if v < _PRUNE_EPS:
                del self._counts[key]
            else:
                self._counts[key] = v
        self.token_freq = self.token_freq * f
        self._agg = self._agg * f
        self._agg_tokens *= f
        self._invalidate()

    # ------------------------------------------------------------- compile
    @property
    def token_prob(self) -> np.ndarray:
        tot = self.token_freq.sum()
        if tot == 0:
            return np.full(self.vocab_size, 1.0 / self.vocab_size)
        return self.token_freq / tot

    def _compile(self, force: bool = False) -> None:
        if not self._dirty:
            return
        if not force and self._dense is not None \
                and self._updates_since_compile < self.refresh_every:
            return                   # serve the previous tensor (throttled)
        L, V, E = self.num_layers, self.vocab_size, self.num_experts
        raw = np.zeros((L, V, E))
        if self._counts:
            keys = np.fromiter(self._counts.keys(), np.int64,
                               len(self._counts))
            vals = np.fromiter(self._counts.values(), float,
                               len(self._counts))
            order = np.argsort(keys)        # insertion-order independent
            keys, vals = keys[order], vals[order]
            layer, f1, _, f3, expert = unpack_key(keys)
            if self.mode == "full":
                tf = self.token_prob
                w = vals * np.maximum(tf[np.clip(f3, 0, V - 1)], 1e-12)
            else:
                w = vals
            np.add.at(raw, (layer, np.clip(f1, 0, V - 1), expert), w)
        self._prior = 1.0 + raw.sum(axis=1)          # (L, E) Laplace
        self._dense = _normalized_rows(raw, self._prior)
        self._dirty = False
        self._updates_since_compile = 0

    def posteriors(self) -> np.ndarray:
        """Dense normalized ``(L, V, E)`` posterior tensor (rows sum to 1).
        Always compiled fresh, regardless of ``refresh_every``."""
        self._compile(force=True)
        return self._dense

    def posterior(self, layer: int, token_id: int) -> np.ndarray:
        self._compile(force=True)
        return self._dense[layer, int(token_id)]

    # ------------------------------------------------------------- predict
    # (the dense kernels are shared with ExpertPredictor — one
    # implementation, one tie-breaking/fallback semantics)
    def predict(self, layer: int, token_ids: np.ndarray,
                k: Optional[int] = None) -> np.ndarray:
        """Eq. 2 (top-k): (N,) token ids -> (N, k) predicted experts."""
        self._compile()
        return dense_predict(self._dense, self._prior, layer, token_ids,
                             k or self.top_k)

    def predict_layers(self, token_ids: np.ndarray,
                       k: Optional[int] = None) -> np.ndarray:
        """All layers at once: (N,) token ids -> (L, N, k) MAP experts."""
        self._compile()
        return dense_predict_layers(self._dense, self._prior, token_ids,
                                    k or self.top_k)

    def predict_demand(self, tokens: np.ndarray, k: Optional[int] = None,
                       mode: str = "map") -> np.ndarray:
        """Predicted per-expert token counts d_{e,i}: (L, E), one
        einsum/argsort pass over the dense posterior."""
        self._compile()
        return dense_predict_demand(self._dense, self._prior, tokens,
                                    k or self.top_k, mode)

    # ------------------------------------------------- window forecasting
    def forecast_demand(self, num_tokens: int) -> Optional[np.ndarray]:
        """Forecast the next window's (L, E) routed counts from the decayed
        window aggregates: observed per-token routing rates scaled to the
        expected token count. ``None`` until the first ``update_demand``."""
        if self._agg_tokens <= 0.0:
            return None
        return self._agg / self._agg_tokens * float(num_tokens)

    def prewarm_hint_matrix(self, token_ids: np.ndarray,
                            k: Optional[int] = None) -> np.ndarray:
        """(L, E) bool — experts the MAP posterior expects the given tokens
        to route to, per layer: the speculative warm-up set the serving
        engine emits ahead of a decode step."""
        preds = self.predict_layers(token_ids, k)    # (L, N, k)
        hints = np.zeros((self.num_layers, self.num_experts), bool)
        for layer in range(self.num_layers):
            hints[layer, preds[layer].ravel()] = True
        return hints

    # -------------------------------------------------------------- state
    @property
    def num_statistics(self) -> int:
        """Live sparse (layer, f1, f3, expert) entries."""
        return len(self._counts)
