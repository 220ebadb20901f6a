"""Calibration metrics for expert-selection prediction.

A copy of ``repro.predict.calibration`` (numpy only): the port imports
nothing of the reference package.

How good is a posterior, operationally? Three views:

* **top-k hit rate** — fraction of realized (token, expert) routing pairs
  whose expert the predictor ranked in its top-k for that token/layer
  (the probability a speculative pre-warm actually lands);
* **prediction difference** — the paper's Fig. 10 metric: mean absolute
  difference between predicted and realized per-expert routed counts;
* **demand error** — aggregate forecast error of a demand matrix
  (absolute + relative), the feedback signal the trace re-planning loop
  and BO's limited range L consume.

All functions duck-type the predictor (``predict(layer, token_ids, k)``),
so both :class:`~repro.predict.posterior.ExpertPredictor` and
:class:`~repro.predict.online.OnlinePredictor` calibrate through the same
code.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.features import LayerRecords


def prediction_difference(demand_pred: np.ndarray,
                          demand_real: np.ndarray, *,
                          per_layer: bool = False):
    """Fig. 10 metric: mean |real - predicted| tokens per expert.

    ``per_layer=True`` returns the (L,) per-layer means instead of the
    scalar (the shape Fig. 10 plots across model variants)."""
    diff = np.abs(np.asarray(demand_pred, float)
                  - np.asarray(demand_real, float))
    return diff.mean(axis=1) if per_layer else float(diff.mean())


def demand_error(demand_pred: np.ndarray,
                 demand_real: np.ndarray) -> Dict[str, float]:
    """Expected-vs-realized demand error of one accounting window."""
    pred = np.asarray(demand_pred, float)
    real = np.asarray(demand_real, float)
    diff = np.abs(pred - real)
    return {
        "mae": float(diff.mean()),
        "max_abs": float(diff.max()),
        "rel_l1": float(diff.sum() / max(real.sum(), 1e-9)),
    }


def topk_hit_rate(predictor, records: Iterable[LayerRecords],
                  k: Optional[int] = None) -> float:
    """Fraction of realized routing pairs covered by the predicted top-k."""
    rep = hit_rate_report(predictor, records, k)
    return rep["hit_rate"]


def hit_rate_report(predictor, records: Iterable[LayerRecords],
                    k: Optional[int] = None) -> Dict:
    """Top-k hit rate overall and per layer.

    For every realized (token -> expert) pair in ``records``, a hit means
    the predictor's top-k for that (layer, token) contains the expert.
    Returns ``{"hit_rate", "pairs", "per_layer": {layer: rate}}``;
    ``hit_rate`` is NaN-free (0.0 on empty records).
    """
    hits = 0
    total = 0
    per_layer_hits: Dict[int, int] = {}
    per_layer_total: Dict[int, int] = {}
    for r in records:
        pred = np.asarray(predictor.predict(r.layer, r.token_id, k))
        experts = np.asarray(r.experts)
        if experts.ndim == 1:
            experts = experts[:, None]
        covered = (experts[:, :, None] == pred[:, None, :]).any(-1)
        h, t = int(covered.sum()), int(covered.size)
        hits += h
        total += t
        per_layer_hits[r.layer] = per_layer_hits.get(r.layer, 0) + h
        per_layer_total[r.layer] = per_layer_total.get(r.layer, 0) + t
    return {
        "hit_rate": hits / total if total else 0.0,
        "pairs": total,
        "per_layer": {layer: per_layer_hits[layer] / per_layer_total[layer]
                      for layer in sorted(per_layer_total)},
    }


def uniform_hit_rate(num_experts: int, k: int = 1) -> float:
    """Hit rate of the uninformed baseline (uniform prior predicts an
    arbitrary fixed top-k): k / E."""
    return min(k / num_experts, 1.0)


def mispredicted_tokens(predictor, records: Iterable[LayerRecords],
                        k: Optional[int] = None) -> np.ndarray:
    """Token IDs with at least one realized expert OUTSIDE the predicted
    top-k — the real prediction errors Alg. 2 line 12 appends to the
    feedback-limited exploration range L."""
    missed: List[np.ndarray] = []
    for r in records:
        pred = np.asarray(predictor.predict(r.layer, r.token_id, k))
        experts = np.asarray(r.experts)
        if experts.ndim == 1:
            experts = experts[:, None]
        covered = (experts[:, :, None] == pred[:, None, :]).any(-1)
        miss = ~covered.all(axis=1)
        if miss.any():
            missed.append(np.unique(np.asarray(r.token_id)[miss]))
    if not missed:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(missed)).astype(np.int64)
