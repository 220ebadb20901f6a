"""Batch expert-selection prediction (paper §III-B, Eqs. 1-2).

A copy of ``repro.predict.posterior`` (numpy only): the port imports
nothing of the reference package.

The posterior of expert N_{e,i} given only the known feature f1' of a new
token marginalizes the unknown position f2 and attention ID f3 through the
profiled joint counts. Expanding Eq. (1), the P'(f2) / P*(f1',f2) factors
cancel between the inner integrand and the outer weight, leaving

    P(N_{e,i} | f1')  ∝  sum_{f2, f3} count(f1', f2, f3, e, i) * P'(f3)

with P'(f3) approximated by the dataset frequency of token f3 (the paper's
stated approximation: the attention ID is itself a token ID). Prediction is
maximum-a-posteriori (Eq. 2), extended to top-k.

``mode="lina"`` reproduces the Lina baseline [USENIX ATC'23]: token-ID-only
posterior, i.e. count(f1', e, i) with no attention-frequency weighting.

``fit()`` additionally compiles the per-(layer, f1) posterior dict into a
dense ``(L, V, E)`` tensor so ``predict`` / ``predict_demand`` run as one
gather + one batched argsort instead of the historical per-layer,
per-unique-token Python loops. The dense rows hold EXACTLY the floats
``posterior()`` returns (same divisions, same fallback rows), so the
vectorized MAP path is bit-identical to the loop path — pinned by
``tests/test_predict_streaming.py`` against the reference implementations
kept at the bottom of this module. Geometries whose dense tensor would
exceed ``DENSE_POSTERIOR_LIMIT`` elements skip compilation and fall back
to the reference loops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.table import KVTable, unpack_key

# (L * V * E) above this never materializes the dense posterior tensor
# (full-vocab models): the reference per-row loops serve instead.
DENSE_POSTERIOR_LIMIT = 1 << 24


def _normalized_rows(raw: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """(L, V, E) raw posterior rows -> normalized, with empty rows falling
    back to the per-layer prior — the same floats ``posterior()`` yields:
    present rows divide by their own ``row.sum()``, absent/zero rows divide
    the prior row by ``prior.sum()`` (always > 0 with the Laplace ones)."""
    sums = raw.sum(axis=-1)                      # (L, V)
    dense = raw / np.where(sums == 0.0, 1.0, sums)[..., None]
    prior_rows = prior / prior.sum(axis=-1, keepdims=True)
    empty_l, empty_v = np.nonzero(sums == 0.0)
    dense[empty_l, empty_v] = prior_rows[empty_l]
    return dense


# --- shared dense-tensor prediction kernels --------------------------------
# One implementation serves ExpertPredictor and OnlinePredictor (the two
# must never diverge). Token ids OUTSIDE [0, V) gather the normalized
# per-layer prior row — exactly the dict-lookup fallback ``posterior()``
# takes for an unseen key, so the dense path stays bit-identical to the
# reference loops even on unsanitized ids.

def _gather_rows(dense: np.ndarray, prior: np.ndarray, layer: int,
                 uniq: np.ndarray) -> np.ndarray:
    V = dense.shape[1]
    rows = dense[layer, np.clip(uniq, 0, V - 1)]
    bad = (uniq < 0) | (uniq >= V)
    if bad.any():
        rows[bad] = prior[layer] / prior[layer].sum()
    return rows


def _gather_rows_all_layers(dense: np.ndarray, prior: np.ndarray,
                            uniq: np.ndarray) -> np.ndarray:
    V = dense.shape[1]
    rows = dense[:, np.clip(uniq, 0, V - 1), :]      # (L, U, E)
    bad = (uniq < 0) | (uniq >= V)
    if bad.any():
        rows[:, bad, :] = (prior / prior.sum(axis=-1,
                                             keepdims=True))[:, None, :]
    return rows


def dense_predict(dense: np.ndarray, prior: np.ndarray, layer: int,
                  token_ids: np.ndarray, k: int) -> np.ndarray:
    """Eq. 2 top-k over dense posterior rows: (N,) ids -> (N, k)."""
    token_ids = np.asarray(token_ids).ravel()
    uniq, inv = np.unique(token_ids, return_inverse=True)
    rows = _gather_rows(dense, prior, layer, uniq)
    return np.argsort(-rows, axis=-1)[:, :k][inv]


def dense_predict_layers(dense: np.ndarray, prior: np.ndarray,
                         token_ids: np.ndarray, k: int) -> np.ndarray:
    """All layers at once: (N,) ids -> (L, N, k) MAP experts."""
    toks = np.asarray(token_ids).ravel()
    uniq, inv = np.unique(toks, return_inverse=True)
    rows = _gather_rows_all_layers(dense, prior, uniq)
    return np.argsort(-rows, axis=-1)[..., :k][:, inv, :]


def dense_predict_demand(dense: np.ndarray, prior: np.ndarray,
                         tokens: np.ndarray, k: int,
                         mode: str) -> np.ndarray:
    """Predicted (L, E) demand in one batched pass over the tensor."""
    L, _, E = dense.shape
    flat = np.asarray(tokens).ravel()
    uniq, cnt = np.unique(flat, return_counts=True)
    rows = _gather_rows_all_layers(dense, prior, uniq)   # (L, U, E)
    if mode == "expected":
        return k * np.einsum('u,lue->le', cnt.astype(float), rows)
    demand = np.zeros((L, E))
    tops = np.argsort(-rows, axis=-1)[..., :k]           # (L, U, k)
    for layer in range(L):
        np.add.at(demand[layer], tops[layer],
                  np.broadcast_to(cnt[:, None].astype(float),
                                  tops[layer].shape))
    return demand


@dataclass
class ExpertPredictor:
    table: KVTable
    mode: str = "full"          # "full" (ours) | "lina" (token-ID only)
    top_k: int = 1
    _post: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)
    _prior: Optional[np.ndarray] = None     # (L, E) per-layer expert prior
    _dense: Optional[np.ndarray] = None     # (L, V, E) normalized posterior

    # ------------------------------------------------------------------ fit
    def fit(self) -> "ExpertPredictor":
        """Compile per-(layer, f1) posteriors from the current table."""
        keys, vals = self.table.entries()
        L, E = self.table.num_layers, self.table.num_experts
        self._post = {}
        self._prior = np.ones((L, E))       # Laplace prior
        if len(keys) == 0:
            self._compile_dense()
            return self
        layer, f1, f2, f3, expert = unpack_key(keys)
        if self.mode == "full":
            tf = self.table.token_prob
            w = vals * np.maximum(tf[np.clip(f3, 0, len(tf) - 1)], 1e-12)
        else:
            w = vals.astype(float)
        # group by (layer, f1, expert)
        group = (layer * self.table.vocab_size + f1) * E + expert
        uniq, inv = np.unique(group, return_inverse=True)
        agg = np.zeros(len(uniq))
        np.add.at(agg, inv, w)
        u_layer = uniq // (self.table.vocab_size * E)
        u_f1 = (uniq // E) % self.table.vocab_size
        u_e = uniq % E
        order = np.lexsort((u_e, u_f1, u_layer))
        u_layer, u_f1, u_e, agg = (a[order] for a in
                                   (u_layer, u_f1, u_e, agg))
        lf = u_layer * self.table.vocab_size + u_f1
        starts = np.searchsorted(lf, np.unique(lf))
        bounds = np.append(starts, len(lf))
        for s, t in zip(bounds[:-1], bounds[1:]):
            li, fi = int(u_layer[s]), int(u_f1[s])
            post = np.zeros(E)
            post[u_e[s:t]] = agg[s:t]
            self._post[(li, fi)] = post
            self._prior[li] += post
        self._compile_dense()
        return self

    def _compile_dense(self) -> None:
        L, E = self.table.num_layers, self.table.num_experts
        V = self.table.vocab_size
        if L * V * E > DENSE_POSTERIOR_LIMIT:
            self._dense = None
            return
        raw = np.zeros((L, V, E))
        for (li, fi), post in self._post.items():
            raw[li, fi] = post
        self._dense = _normalized_rows(raw, self._prior)

    # -------------------------------------------------------------- predict
    def posterior(self, layer: int, token_id: int) -> np.ndarray:
        assert self._prior is not None, "call fit() first"
        p = self._post.get((layer, int(token_id)))
        if p is None or p.sum() == 0:
            p = self._prior[layer]
        s = p.sum()
        return p / s if s > 0 else np.full(len(p), 1.0 / len(p))

    def posteriors(self) -> np.ndarray:
        """The dense normalized ``(L, V, E)`` posterior tensor (each row a
        distribution over experts). Requires a geometry under
        ``DENSE_POSTERIOR_LIMIT``."""
        assert self._prior is not None, "call fit() first"
        if self._dense is None:
            raise ValueError(
                "posterior tensor would exceed DENSE_POSTERIOR_LIMIT "
                f"({self.table.num_layers}x{self.table.vocab_size}x"
                f"{self.table.num_experts}); use posterior(layer, token)")
        return self._dense

    def predict(self, layer: int, token_ids: np.ndarray,
                k: Optional[int] = None) -> np.ndarray:
        """Eq. 2 (top-k): (N,) token ids -> (N, k) predicted experts."""
        k = k or self.top_k
        if self._dense is None:
            return predict_reference(self, layer, token_ids, k)
        return dense_predict(self._dense, self._prior, layer, token_ids, k)

    def predict_demand(self, tokens: np.ndarray, k: Optional[int] = None,
                       mode: str = "map") -> np.ndarray:
        """Predicted per-expert token counts d_{e,i}: (L, E).

        ``mode="map"`` assigns every token instance to its MAP experts
        (Eq. 2, the paper's method) — one batched argsort over the dense
        tensor, exactly equal to the per-token loop (integer-count
        accumulation is order-free). ``mode="expected"`` accumulates the
        full posterior instead — a beyond-paper improvement that captures
        positionally-spread routing (EXPERIMENTS.md §Repro ablation) —
        as one einsum over the gathered rows (equal to the loop within
        float-summation-order tolerance).
        """
        k = k or self.top_k
        if self._dense is None:
            return predict_demand_reference(self, tokens, k=k, mode=mode)
        return dense_predict_demand(self._dense, self._prior, tokens, k,
                                    mode)

    # --------------------------------------------------------------- metrics
    def prediction_difference(self, demand_pred: np.ndarray,
                              demand_real: np.ndarray) -> float:
        """Fig. 10 metric: mean |real - predicted| tokens per expert
        (delegates to :func:`repro.predict.calibration
        .prediction_difference`, kept as a method for compatibility)."""
        from repro_torch.predict.calibration import prediction_difference
        return prediction_difference(demand_pred, demand_real)


# ---------------------------------------------------------------------------
# Reference (pre-vectorization) implementations. These are the PR-4 hot-path
# loops, kept verbatim as the differential oracle for the vectorized paths
# (tests/test_predict_streaming.py) and as the fallback for geometries too
# large for the dense tensor; benchmarks/fig10_prediction.py times the gap.
# ---------------------------------------------------------------------------

def predict_reference(pred: ExpertPredictor, layer: int,
                      token_ids: np.ndarray,
                      k: Optional[int] = None) -> np.ndarray:
    """Per-unique-token loop of the historical ``predict``."""
    k = k or pred.top_k
    token_ids = np.asarray(token_ids).ravel()
    uniq, inv = np.unique(token_ids, return_inverse=True)
    tops = np.stack([
        np.argsort(-pred.posterior(layer, t))[:k] for t in uniq])
    return tops[inv]


def predict_demand_reference(pred: ExpertPredictor, tokens: np.ndarray,
                             k: Optional[int] = None,
                             mode: str = "map") -> np.ndarray:
    """Per-layer, per-unique-token loop of the historical
    ``predict_demand``."""
    k = k or pred.top_k
    L, E = pred.table.num_layers, pred.table.num_experts
    demand = np.zeros((L, E))
    flat = np.asarray(tokens).ravel()
    uniq, cnt = np.unique(flat, return_counts=True)
    for layer in range(L):
        if mode == "expected":
            for u, c in zip(uniq, cnt):
                demand[layer] += c * k * pred.posterior(layer, int(u))
        else:
            rows = np.stack([np.argsort(-pred.posterior(layer, int(u)))[:k]
                             for u in uniq])
            for row, c in zip(rows, cnt):
                demand[layer, row] += c
    return demand
