"""Dispatch substrate shared by the simulator and the serving engine.

The parts of ``repro.dispatch`` the port has, in its own copies:
:class:`ChunkPlan` (the per-layer chunk schedule of a
:class:`~repro_torch.plan.schema.DeploymentPlan`), the fault-drawing
policy helpers the simulator uses, and :class:`RoundAccumulator` (the
serving engine's dispatch rounds). The transports and the chunked
dispatcher wait for ``repro.dist`` (ROADMAP.md, Queue A item 1).
"""
from repro_torch.dispatch.chunks import ChunkPlan, chunk_count
from repro_torch.dispatch.policy import (DispatchPolicy, WaveState,
                                         draw_failures, draw_straggler,
                                         draw_temperature)
from repro_torch.dispatch.rounds import RoundAccumulator

__all__ = [
    "ChunkPlan", "chunk_count",
    "DispatchPolicy", "WaveState",
    "draw_temperature", "draw_straggler", "draw_failures",
    "RoundAccumulator",
]
