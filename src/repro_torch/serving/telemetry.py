"""Live expert-popularity telemetry from the serving path (paper §III-B).

A copy of ``repro.serving.telemetry`` (numpy only): the port imports
nothing of the reference package.

The offline pipeline profiles token-to-expert mappings by replaying a
corpus through ``Model.forward(capture=True)``. This module captures the
SAME observations from real serving traffic — prefill and per-step decode
routing — so the deployment planner can re-plan from what the engine
actually executed instead of an offline estimate (the online
routing-statistics loop of the serverless-MoE systems in PAPERS.md).

Two products:

* a live ``(num_layers, num_experts)`` routed-token demand matrix, the
  direct input to ``ServerlessMoERuntime.plan()``;
* full per-token feature records (f1 token ID, f2 position, f3 attention
  ID, routed experts) in the exact :class:`LayerRecords` format the
  :class:`repro.core.table.KVTable` profiles from, so serving traffic
  folds into the predictor's key-value table via ``flush_to_table``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.features import LayerRecords, extract_features


class ExpertTelemetry:
    """Accumulates routing observations from prefill and decode steps."""

    def __init__(self, num_layers: int, num_experts: int, vocab_size: int,
                 pattern_len: int):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.vocab_size = vocab_size
        self.pattern_len = pattern_len
        self.demand = np.zeros((num_layers, num_experts))
        # pairs the execution path REFUSED to compute (capacity-buffer
        # drops); identically zero under the dropless grouped executor
        self.drop_counts = np.zeros((num_layers, num_experts))
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self._records: List[LayerRecords] = []
        self._token_freq = np.zeros(vocab_size)   # pending flush buffer
        self.served_freq = np.zeros(vocab_size)   # cumulative served tokens
        # speculative-dispatch scoreboard (engine prewarm hints vs what
        # the step actually routed)
        self.prewarm_hits = 0        # routed pairs covered by a hint
        self.prewarm_misses = 0      # hinted (layer, expert) cells unused
        self.prewarm_pairs = 0       # routed pairs scored
        self.prewarm_hits_by_layer = np.zeros(num_layers)
        self.prewarm_pairs_by_layer = np.zeros(num_layers)

    # -------------------------------------------------------------- routing
    def _ingest_routing(self, captures: Dict) -> None:
        """Fold per-layer RoutingSummary captures (``cap["routing"]``,
        leaves stacked (num_blocks, ...)) into the drop ledger."""
        for p in range(self.pattern_len):
            cap = captures.get(f"pos{p}", {})
            summary = cap.get("routing") if hasattr(cap, "get") else None
            if summary is None:
                continue
            # summary rows span the model's PADDED expert axis (sharding
            # alignment); pad experts never receive tokens, so slicing to
            # the real expert count loses nothing
            dropped = np.asarray(summary.dropped)[:, :self.num_experts]
            for b in range(dropped.shape[0]):
                self.drop_counts[b * self.pattern_len + p] += dropped[b]

    def dropped_matrix(self) -> np.ndarray:
        """Cumulative (L, E) pairs dropped by the execution path — the
        silent capacity tax the grouped executor eliminates."""
        return np.nan_to_num(self.drop_counts, copy=True, posinf=0.0,
                             neginf=0.0)

    # -------------------------------------------------------------- prefill
    def record_prefill(self, tokens: np.ndarray, captures: Dict) -> None:
        """``tokens``: (1, S) prompt; ``captures``: aux["captures"] from
        ``Model.prefill(..., capture=True)`` (host arrays)."""
        tokens = np.asarray(tokens)
        self._ingest_routing(captures)
        recs = extract_features(tokens, captures, self.pattern_len)
        for r in recs:
            np.add.at(self.demand[r.layer], r.experts.ravel(), 1.0)
        self._records.extend(recs)
        binc = np.bincount(tokens.ravel(), minlength=self.vocab_size)
        self._token_freq += binc
        self.served_freq += binc
        self.prefill_tokens += tokens.size

    # --------------------------------------------------------------- decode
    def record_decode(self, input_tokens: np.ndarray,
                      positions: np.ndarray,
                      seqs: Sequence[np.ndarray],
                      captures: Dict[str, Dict[str, Any]],
                      active: Sequence[int],
                      n_front: int = 0) -> None:
        """One batched decode step.

        ``input_tokens``/``positions``: (num_slots,) token fed to each slot
        and its raw-stream position (frontend offset already removed);
        ``seqs[i]``: the full raw token history of slot ``i`` (prompt +
        generated so far) for attention-ID lookup; ``captures``: the
        ``pos{p}`` capture dict from ``decode_step(capture=True)`` (host
        arrays, leaves stacked (num_blocks, num_slots, 1, ...));
        ``active``: slot indices that hold live requests this step.
        """
        if not active:
            return
        self._ingest_routing(captures)
        act = np.asarray(list(active), np.int64)
        # defensive: keys must stay inside the table's vocab (the engine
        # already restricts sampling to the valid vocab)
        tok = np.clip(np.asarray(input_tokens)[act], 0, self.vocab_size - 1)
        pos = np.asarray(positions)[act]
        for p in range(self.pattern_len):
            cap = captures.get(f"pos{p}", {})
            if "topk_idx" not in cap:
                continue
            topk = np.asarray(cap["topk_idx"])        # (nb, B, 1, k)
            w = np.asarray(cap["topk_weight"])
            nb = topk.shape[0]
            am = (np.asarray(cap["attn_argmax"])
                  if "attn_argmax" in cap else None)  # (nb, B, 1)
            for b in range(nb):
                layer = b * self.pattern_len + p
                experts = topk[b, act, 0]             # (N, k)
                np.add.at(self.demand[layer], experts.ravel(), 1.0)
                if am is None:
                    attn_id = tok                     # self-attention-ID
                else:
                    attn_id = np.empty(len(act), np.int64)
                    for j, i in enumerate(act):
                        seq = seqs[i]
                        idx = int(am[b, i, 0]) - n_front
                        attn_id[j] = seq[np.clip(idx, 0, len(seq) - 1)]
                self._records.append(LayerRecords(
                    layer=layer,
                    token_id=tok.astype(np.int64),
                    position=pos.astype(np.int64),
                    attention_id=attn_id,
                    experts=experts.reshape(len(act), -1),
                    weights=w[b, act, 0].reshape(len(act), -1),
                ))
        binc = np.bincount(tok, minlength=self.vocab_size)
        self._token_freq += binc
        self.served_freq += binc
        self.decode_tokens += len(act)

    # ------------------------------------------------------- speculation
    def records_since(self, mark: int) -> List[LayerRecords]:
        """Pending records appended after ``mark`` (= ``num_records`` taken
        before a record call) — the engine streams these into its online
        predictor each step."""
        return self._records[mark:]

    @property
    def num_records(self) -> int:
        return len(self._records)

    def record_prewarm(self, hints: np.ndarray,
                       step_demand: np.ndarray) -> None:
        """Score one decode step's speculative prewarm hints.

        ``hints``: (L, E) bool — experts the engine speculatively warmed
        before the step; ``step_demand``: (L, E) routed-pair counts the
        step actually produced. A routed pair on a hinted expert is a
        hit (that container was warm when the scatter arrived); a hinted
        expert with zero routed pairs is a miss (wasted warm-up)."""
        hints = np.asarray(hints, bool)
        d = np.asarray(step_demand, float)
        assert hints.shape == d.shape == self.demand.shape, \
            (hints.shape, d.shape)
        hit_pairs = np.where(hints, d, 0.0)
        self.prewarm_hits += int(hit_pairs.sum())
        self.prewarm_pairs += int(d.sum())
        self.prewarm_misses += int((hints & (d <= 0.0)).sum())
        self.prewarm_hits_by_layer += hit_pairs.sum(axis=1)
        self.prewarm_pairs_by_layer += d.sum(axis=1)

    def prewarm_hit_rate(self) -> Optional[float]:
        """Fraction of routed pairs whose expert was speculatively warmed
        (None before any scored step)."""
        if self.prewarm_pairs == 0:
            return None
        return self.prewarm_hits / self.prewarm_pairs

    # ------------------------------------------------------------- planning
    def demand_matrix(self) -> np.ndarray:
        """Cumulative (L, E) routed-token counts observed while serving.

        Always finite and all-zero before any traffic, so planners can
        consume it unconditionally."""
        return np.nan_to_num(self.demand, copy=True, posinf=0.0,
                             neginf=0.0)

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def is_empty(self) -> bool:
        """True while zero tokens (prefill or decode) have been served."""
        return self.total_tokens == 0

    def served_token_stream(self) -> np.ndarray:
        """Served tokens with multiplicity (order-free) for the predictor."""
        return np.repeat(np.arange(self.vocab_size, dtype=np.int64),
                         self.served_freq.astype(np.int64))

    def reset(self) -> None:
        self.demand[:] = 0.0
        self.drop_counts[:] = 0.0
        self._token_freq[:] = 0.0
        self.served_freq[:] = 0.0
        self._records.clear()
        self.prefill_tokens = self.decode_tokens = 0
        self.prewarm_hits = self.prewarm_misses = self.prewarm_pairs = 0
        self.prewarm_hits_by_layer[:] = 0.0
        self.prewarm_pairs_by_layer[:] = 0.0

    # -------------------------------------------------------------- KVTable
    def flush_to_table(self, table) -> int:
        """Fold pending records into a :class:`repro.core.table.KVTable`.

        Updates the table's token-frequency prior and per-key counts, then
        clears the pending record buffer (the cumulative demand matrix is
        kept). Returns the number of LayerRecords ingested; with nothing
        pending (zero served tokens since the last flush) this is a
        no-op returning 0.
        """
        if table.vocab_size != self.vocab_size:
            raise ValueError(
                f"telemetry vocab ({self.vocab_size}) does not match the "
                f"table's ({table.vocab_size}); they must profile the "
                "same tokenizer")
        n = len(self._records)
        if n == 0 and not self._token_freq.any():
            return 0
        table.token_freq = table.token_freq + self._token_freq
        table.add_records(self._records)
        self._records.clear()
        self._token_freq = np.zeros(self.vocab_size)
        return n
