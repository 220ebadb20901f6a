"""Scatter-gather communication time models (paper §III-C/D, Eqs. 3-11).

A copy of ``repro.core.comm`` (numpy only): the port imports
nothing of the reference package.

Three designs per MoE layer:

* ``a=1`` pipelined indirect transfer via external storage, pipeline degree
  beta (max minibatch size): downloading + computing minibatch t overlaps
  with uploading minibatch t-1 (paper Fig. 6a / 8a).
* ``a=2`` non-pipelined indirect transfer (Fig. 6b / 8b).
* ``a=3`` direct function invocation (Fig. 7 / 9), infeasible when a
  replica's input exceeds the payload cap (Eq. 12f).

Typo resolutions vs. the printed equations (documented per DESIGN.md):
Eq. (6) multiplies the per-block time by beta where the derivation from
Fig. 8(a) requires the NUMBER OF MINIBATCHES ceil(r/beta); and the block
time's max{} must compare whole-minibatch quantities. We implement the
Fig.-8(a)-consistent form:

    t_rep1 = T_h + n_mb * t_blk + t_tail
    n_mb   = ceil(r / beta)
    t_blk  = T_dl + max(beta*(D_in/B_s + t_cal), beta*D_o/B_s)
    t_tail = T_dl + beta * D_o / B_s          (last upload, not overlapped)

Eqs. (8) and (10) are implemented as printed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.core.costmodel import MB, ModelProfile, PlatformSpec

METHODS = (1, 2, 3)


@dataclass(frozen=True)
class LayerTimes:
    """Per-expert replica times + layer latency for one (method, layer)."""

    t_rep: np.ndarray        # (num_experts,) seconds per replica
    t_total: np.ndarray      # (num_experts,) Eq. 5: sum over replicas = g*t_rep
    t_latency: float         # MoE-E2E latency t^lat_{a,e}
    feasible: np.ndarray     # (num_experts,) bool (payload constraint)


def t_cal_per_token(u_ref_s: float, mem_mb: np.ndarray,
                    spec: PlatformSpec) -> np.ndarray:
    """Eq. (3): per-token compute time at the chosen memory size."""
    slow = np.array([spec.cpu_slowdown(m) for m in np.atleast_1d(mem_mb)])
    return u_ref_s * slow


def head_time(prof: ModelProfile, spec: PlatformSpec) -> float:
    """T^{h,E}: warm start + storage access + expert parameter download."""
    return (spec.t_warm_start_s + spec.t_storage_access_s
            + prof.expert_param_bytes / (spec.bw_storage_mb_s * MB))


def layer_times(method: int, r: np.ndarray, g: np.ndarray,
                mem_mb: np.ndarray, beta: int, prof: ModelProfile,
                spec: PlatformSpec) -> LayerTimes:
    """Times for one MoE layer.

    r: (E,) tokens per replica; g: (E,) replica counts; mem_mb: (E,).
    """
    r = np.asarray(r, float)
    g = np.asarray(g, float)
    mem_mb = np.asarray(mem_mb, float)
    E = r.shape[0]
    bs = spec.bw_storage_mb_s * MB
    bf = spec.bw_direct_mb_s * MB
    tdl = spec.t_storage_access_s
    t_h = head_time(prof, spec)
    t_cal = t_cal_per_token(prof.u_ref_s, mem_mb, spec)
    d_in, d_o = prof.token_in_bytes, prof.token_out_bytes
    feasible = np.ones(E, bool)

    if method == 1:
        beta = max(int(beta), 1)
        n_mb = np.ceil(r / beta)
        t_blk = tdl + np.maximum(beta * (d_in / bs + t_cal),
                                 beta * d_o / bs)
        t_tail = tdl + beta * d_o / bs
        t_rep = t_h + n_mb * t_blk + t_tail
        # stage 3: the next non-MoE layer downloads all processed results
        t_s3 = tdl + (r * g).sum() * d_o / bs
        t_s12 = float(np.max(t_rep, initial=0.0))
        t_lat = max(t_s12, prof.t_load_s(spec)) + t_s3
    elif method == 2:
        t_data = r * ((d_in + d_o) / bs + t_cal)
        t_rep = t_h + 2 * tdl + t_data                       # Eq. (8)
        t_s3 = tdl + (r * g).sum() * d_o / bs
        t_s12 = float(np.max(t_rep, initial=0.0))
        t_lat = max(t_s12, prof.t_load_s(spec)) + t_s3       # Eq. (9)
    elif method == 3:
        t_rep = t_h + r * (d_o / bf + t_cal)                 # Eq. (10)
        feasible = r * d_in <= spec.payload_bytes            # Eq. (12f)
        t_in = float(np.max(r * d_in / bf, initial=0.0))
        t_lat = t_in + float(np.max(t_rep, initial=0.0)) \
            + prof.t_load_s(spec)                            # Eq. (11)
    else:
        raise ValueError(method)

    t_rep = np.where(r > 0, t_rep, 0.0)
    return LayerTimes(t_rep=t_rep, t_total=g * t_rep, t_latency=float(t_lat),
                      feasible=feasible)


def layer_billed_cost(times: LayerTimes, mem_mb: np.ndarray,
                      spec: PlatformSpec) -> float:
    """Eq. (4): sum over selected experts of execution time x memory."""
    mem_gb = np.asarray(mem_mb, float) / 1024.0
    return float(np.sum(times.t_total * mem_gb) * spec.price_per_gb_s)


def memory_required_mb(r: np.ndarray, prof: ModelProfile) -> np.ndarray:
    """LHS of Eq. (12c): parameters + intermediates + in/out buffers."""
    r = np.asarray(r, float)
    return (prof.expert_param_bytes
            + prof.intermediate_bytes
            + r * (prof.token_in_bytes + prof.token_out_bytes)) / MB
