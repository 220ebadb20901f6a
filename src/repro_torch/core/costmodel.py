"""Serverless platform specification and billing model (AWS Lambda, §V-A).

A copy of ``repro.core.costmodel`` (numpy only): the port imports
nothing of the reference package.

All constants are calibrated to the paper's testbed where stated (memory
option list, payload size, replica cap) and to published AWS Lambda /
S3 characteristics otherwise (pricing, bandwidths, start latencies).
Everything is a dataclass field so experiments can sweep them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

MB = 1024 ** 2
GB = 1024 ** 3


@dataclass(frozen=True)
class PlatformSpec:
    """A CPU serverless platform (AWS Lambda-like)."""

    # paper §V-A: the 14 discrete memory configurations (MB)
    memory_options_mb: Tuple[int, ...] = (
        128, 768, 960, 1152, 1344, 1536, 1728, 1920, 2112, 2304, 2496,
        2688, 2880, 3072)
    price_per_gb_s: float = 1.66667e-5      # USD / GB-second (Lambda x86)
    payload_mb: float = 6.0                 # D^p, paper Fig. 4
    bw_storage_mb_s: float = 90.0           # B^s: fn <-> S3 bandwidth
    bw_direct_mb_s: float = 160.0           # B^f: fn <-> fn payload bandwidth
    t_storage_access_s: float = 0.012       # T^dl: S3 access delay per op
    #   (same-region S3 GET from Lambda: ~10-15 ms first byte)
    t_warm_start_s: float = 0.05            # T^str
    t_cold_start_s: float = 5.0             # cold start (deploy-time only)
    t_deploy_s: float = 60.0                # function (re)deployment
    max_replicas: int = 8                   # G, paper §V-A
    # Lambda vCPU share scales ~linearly with memory; full speed at the top
    # option. cpu_speed(mem) multiplies per-token compute time.
    full_speed_mem_mb: int = 3072
    min_speed_frac: float = 0.06            # 128MB floor
    # a speculatively pre-warmed container idles warm for this long; a
    # MISpredicted prewarm bills these GB-seconds for nothing (provisioned
    # concurrency pricing model). Only consulted when a prewarmer runs.
    t_prewarm_keepalive_s: float = 1.0
    # --- expert-weight cache (repro.expcache, Remoe/MoEless model) ----
    # an intra-container expert SWAP: fixed runtime overhead plus the
    # weight transfer at the swap bandwidth (container-local NVMe /
    # same-zone object store — orders of magnitude above bw_storage).
    # Swap seconds are billed like any other busy time; the point of the
    # cache is that t_swap_s(weights) << t_cold_start_s.
    t_swap_fixed_s: float = 0.08
    bw_swap_mb_s: float = 1500.0
    # a cache-RESIDENT container that goes a whole window unused bills
    # this much idle keep-alive per window before retiring. Deliberately
    # a separate knob from t_prewarm_keepalive_s: prewarm keep-alive
    # prices a one-shot speculative warm-up, cache keep-alive prices
    # holding weights resident between windows. Only consulted when a
    # cache model is attached to a run.
    t_cache_keepalive_s: float = 0.5

    def cpu_slowdown(self, mem_mb: float) -> float:
        """Per-token compute-time multiplier at a given memory size."""
        frac = max(self.min_speed_frac,
                   min(1.0, mem_mb / self.full_speed_mem_mb))
        return 1.0 / frac

    def billed_cost(self, mem_mb: float, seconds: float) -> float:
        """GB-seconds * price."""
        return (mem_mb / 1024.0) * max(seconds, 0.0) * self.price_per_gb_s

    def t_swap_s(self, nbytes: float) -> float:
        """Wall-clock to swap ``nbytes`` of expert weights into an
        already-warm container (fixed overhead + transfer)."""
        return self.t_swap_fixed_s + max(float(nbytes), 0.0) \
            / (self.bw_swap_mb_s * MB)

    @property
    def payload_bytes(self) -> float:
        return self.payload_mb * MB


@dataclass(frozen=True)
class CPUClusterSpec:
    """The paper's CPU-cluster baseline: 2x 64-core AMD EPYC, 512 GB DRAM.

    Billed per hour whether busy or idle (the paper's core contrast with
    pay-per-use serverless). Rate modeled on 2x m7a.16xlarge on-demand.
    """

    hourly_rate_usd: float = 7.40
    num_cores: int = 128
    dram_gb: int = 512
    # relative per-token speed vs one full-speed serverless function
    speedup_vs_function: float = 24.0
    better_transformer_speedup: float = 1.6   # §V-G baseline (6)

    def billed_cost(self, seconds: float) -> float:
        return self.hourly_rate_usd * seconds / 3600.0


@dataclass(frozen=True)
class ModelProfile:
    """Per-architecture quantities the deployment problem consumes.

    ``u_ref_s``: seconds to process one token in one expert at the largest
    memory option (calibrated by timing the real JAX expert FFN; see
    ``repro.core.runtime.calibrate_u_ref``).
    """

    num_moe_layers: int
    experts_per_layer: int
    expert_param_bytes: float        # P_{e,i}
    token_in_bytes: float            # D^in (activation of one token)
    token_out_bytes: float           # D^o
    u_ref_s: float                   # per-token expert compute at full speed
    intermediate_bytes: float        # M^itrm per token resident in memory
    nonmoe_param_bytes: float        # for T^load of the next non-MoE layer
    t_nonmoe_s: float = 0.05         # T^NE per layer
    t_head_s: float = 0.1            # T^head (first non-MoE fn)
    t_tail_s: float = 0.1            # T^tail

    def t_load_s(self, spec: PlatformSpec) -> float:
        """T^load: start the next non-MoE fn + download its parameters."""
        return (spec.t_warm_start_s + spec.t_storage_access_s
                + self.nonmoe_param_bytes / (spec.bw_storage_mb_s * MB))
