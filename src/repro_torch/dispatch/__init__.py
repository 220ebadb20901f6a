"""Dispatch-round bookkeeping shared by the serving engine."""
from repro_torch.dispatch.rounds import RoundAccumulator  # noqa: F401
