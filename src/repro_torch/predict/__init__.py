"""Expert-selection prediction (paper §III-B, Eqs. 1-2) — batch + online.

A copy of ``repro.predict`` (numpy only): the port imports
nothing of the reference package.

Grown from ``repro.core.predictor`` (which remains as a compatibility
shim) into a first-class subsystem:

* :class:`ExpertPredictor` — the batch Eq. 1-2 posterior fitted from a
  profiled :class:`~repro.core.table.KVTable`, with the MAP hot paths
  (``predict`` / ``predict_demand``) vectorized over a dense (L, V, E)
  posterior tensor;
* :class:`OnlinePredictor` — streaming sufficient statistics with
  ``update()`` provably equivalent to a full refit, sliding-window
  exponential decay for popularity drift, and window-level
  ``forecast_demand`` for the trace re-planning loop;
* :mod:`~repro.predict.calibration` — top-k hit rate, Fig. 10
  prediction difference, demand error, and the mispredicted-token set
  feeding BO's limited exploration range L (Alg. 2 line 12);
* :mod:`~repro.predict.prewarm` — forecast -> speculative container
  warm-up orders for the simulator's warm pool and the serving engine's
  speculative dispatch stage.

Pure numpy: importable by the simulator, benchmarks, and tests without
JAX warm-up.
"""
from repro_torch.predict.calibration import (demand_error, hit_rate_report,
                                             mispredicted_tokens,
                                             prediction_difference, topk_hit_rate,
                                             uniform_hit_rate)
from repro_torch.predict.online import OnlinePredictor
from repro_torch.predict.posterior import (DENSE_POSTERIOR_LIMIT, ExpertPredictor,
                                           predict_demand_reference,
                                           predict_reference)
from repro_torch.predict.prewarm import (PrewarmEvent, prewarm_containers,
                                         prewarm_events, prewarm_matrix,
                                         prewarm_oracle)

__all__ = [
    "ExpertPredictor", "OnlinePredictor", "DENSE_POSTERIOR_LIMIT",
    "predict_reference", "predict_demand_reference",
    "prediction_difference", "demand_error", "topk_hit_rate",
    "hit_rate_report", "uniform_hit_rate", "mispredicted_tokens",
    "PrewarmEvent", "prewarm_containers", "prewarm_oracle",
    "prewarm_events", "prewarm_matrix",
]
