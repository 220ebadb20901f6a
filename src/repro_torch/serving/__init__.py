"""Continuous-batching serving with live expert telemetry (the port's
counterpart of ``repro.serving``)."""
from repro_torch.serving.engine import ENGINE_KERNELS, ServingEngine  # noqa: F401
from repro_torch.serving.kv_slots import SlotKVCache  # noqa: F401
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serving.scheduler import (Request, RequestState,  # noqa: F401
                                           SlotScheduler)
from repro_torch.serving.telemetry import ExpertTelemetry  # noqa: F401
