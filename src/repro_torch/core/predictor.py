"""Compatibility shim: the predictor moved to :mod:`repro.predict`.

A copy of ``repro.core.predictor`` (numpy only): the port imports
nothing of the reference package.

``repro.core.predictor.ExpertPredictor`` remains importable (planner, BO,
benchmarks, and user code predate the move); new code should import from
:mod:`repro.predict`, which also houses the streaming
:class:`~repro.predict.online.OnlinePredictor`, calibration metrics, and
the pre-warming helpers.
"""
from repro_torch.predict.posterior import (ExpertPredictor,
                                           predict_demand_reference,
                                           predict_reference)

__all__ = ["ExpertPredictor", "predict_reference",
           "predict_demand_reference"]
