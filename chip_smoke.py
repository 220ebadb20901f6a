#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

Run from the root of a checkout (it needs one CUDA device)::

    python3 chip_smoke.py

It imports only ``repro_torch`` (from ``src/``), torch and numpy, and
prints one JSON line per phase:

1. ``build``: compile every kernel of ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, all at once).
2. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, in float32 and bfloat16, at the serving path's
   shapes (gpt2-moe: D 768, F 3072, E 4, k 1, GELU; qwen2-moe-a2.7b:
   D 2048, F 1408, E 60, k 4, SwiGLU), plus a padded token count and a
   tie for the router and a GQA case (4 query heads per KV head) for
   flash-decode. Integers must be equal; floats within the kernel
   harness's bounds (f32 3e-5, bf16 2e-2; the router's float outputs
   1e-5). Times come from CUDA events around single calls with the 50 MB
   L2 cache flushed before each (the serving path meets every layer's
   weights cold).
3. ``serve_gpt2``: ``ServingEngine`` on full-width gpt2-moe (12 layers,
   random weights from seed 0) in float32: 4 slots, ``max_len`` 128, six
   prompts of 8-16 tokens from ``numpy.random.default_rng(0)``, 8 new
   tokens each; once with expert telemetry (router and grouped kernels
   must launch) and once without (all three must launch). The first
   prompt's prefill logits are held against the plain path on the CPU.
4. ``serve_qwen2``: the same on qwen2-moe-a2.7b at full width, depth cut
   to 2 layers.
5. ``runtime_gpt2``: the paper's runtime loop (``ServerlessMoERuntime``)
   on full-width gpt2-moe: construction (``calibrate_u_ref`` times the
   capacity FFN kernel), ``profile_table()`` (capture forwards through
   the dense executor: fused router, capacity buffers, capacity FFN
   kernel, combine; 12 of each kernel per forward), ``plan_bo`` (ODS and
   BO over the simulator backend), the simulator's bill, serving six
   prompts through the serving backend (grouped path) and re-planning
   from the live telemetry. One capture forward's logits are held
   against the plain path on the CPU.

The kernels phase also holds the capacity FFN (B4) at the runtime's
shapes and the gating-only router (B5) against their plain versions.

Then the card's name and power limit (``nvidia-smi``), the kernel table
(``{"kernels": [...]}``, launch counts from the path runs, each row with
the phases it launched in) and, last, ``{"ok": true, "device": {...}}``.
A failed check raises, so the script exits non-zero before the last
line; without a CUDA device it exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import Model, ServingEngine, get_arch  # noqa: E402
from repro_torch.core.runtime import (RuntimeConfig,  # noqa: E402
                                      ServerlessMoERuntime)
from repro_torch.kernels import (KERNELS, _build, launch_counts,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.expert_ffn.ops import capacity_ffn  # noqa: E402
from repro_torch.kernels.expert_ffn.ref import capacity_ffn_ref  # noqa: E402
from repro_torch.kernels.grouped_moe.ops import grouped_moe_ffn  # noqa: E402
from repro_torch.kernels.grouped_moe.ref import grouped_moe_ref  # noqa: E402
from repro_torch.kernels.router_topk.ops import (router_topk,  # noqa: E402
                                                 router_topk_fused)
from repro_torch.kernels.router_topk.ref import (router_topk_fused_ref,  # noqa: E402
                                                 router_topk_ref,
                                                 stable_ranks)
from repro_torch.models.moe import (FusedRouting, dispatch_grouped,  # noqa: E402
                                    grouped_dispatch_from_fused)
from repro_torch.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.plan.schema import Workload  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type
# (float32 outside the tensor cores; bfloat16 on them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
ROUTER_FLOAT_TOL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
GPT2 = dict(D=768, F=3072, E=4, k=1, activation="gelu", heads=12, hd=64)
QWEN2 = dict(D=2048, F=1408, E=60, k=4, activation="swiglu", heads=16,
             hd=128)
SLOTS, MAX_LEN, NEW_TOKENS = 4, 128, 8
# kernels that no model path of either package runs: their launches come
# from the kernels phase only
OFF_PATH = {"router_topk": "B5 (gating only) has no model path in either "
                           "package; the reference calls it from its tests "
                           "and kernel benchmark only"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --------------------------------------------------------------- measuring

class ColdTimer:
    """Milliseconds of single calls on the device, each bracketed by CUDA
    events after a 64 MiB write has pushed the inputs out of the 50 MB L2
    cache. A spin kernel queued first keeps the device busy while the host
    enqueues every call, so the events bracket device work, not the
    wrapper's host overhead (``host_ms`` measures that: wall per call,
    synchronised). A call that synchronises itself (the plain grouped FFN
    reads ``tile_expert`` on the host) still shows its host time."""

    SPIN_CYCLES = 200_000_000        # about 0.1 s at the H100's clock

    def __init__(self, device: torch.device, iters: int = 20):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.iters = iters

    def __call__(self, fn: Callable[[], object]) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.iters)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for start, end in pairs:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / self.iters

    def host_ms(self, fn: Callable[[], object]) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / self.iters * 1e3


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, dtype: torch.dtype) -> Dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the type's peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(bytes_moved), "bound_ops": int(ops)}


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------------ kernels

def router_case(dev, dtype, N, D, E, k, *, tie=False, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(N, D, generator=g, device=dev)
    w = torch.randn(D, E, generator=g, device=dev) / D ** 0.5
    if tie:
        # experts 1 and 2 lead for every token with identical columns
        x[:, 0] = x[:, 0].abs() + 0.5
        w[0, :] = -10.0
        w[0, 1] = 5.0
        w[:, 2] = w[:, 1]
    return x.to(dtype), w.to(dtype)


def check_router(dev, dtype, N, D, E, k, label, tie=False):
    x, w = router_case(dev, dtype, N, D, E, k, tie=tie)
    got = router_topk_fused(x, w, k=k)
    want = router_topk_fused_ref(x, w, k=k)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("vals", "idx", "pos", "counts", "probs_sum",
                           "z_sq"), got, want):
        if a.dtype == torch.int32:
            check(torch.equal(a, b), f"router {label} {dtype}: {name} differ")
        else:
            e = max_abs(a, b) / max(1.0, float(b.abs().max()))
            check(e <= ROUTER_FLOAT_TOL,
                  f"router {label} {dtype}: {name} off by {e}")
            err = max(err, max_abs(a, b))
    if tie:
        check(bool((got[1][:, :2] == torch.tensor([1, 2], device=dev)
                    ).all()), "router tie: lowest index must win")
    return err, (x, w, k)


def grouped_case(dev, dtype, N, D, F_, E, k, activation, seed=0):
    """The grouped layout of N tokens routed top-k at random over E experts
    (as the serving path builds it), with random expert weights."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.stack([rng.choice(E, k, replace=False)
                                    for _ in range(N)]), dtype=torch.int32,
                          device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    pos, counts = stable_ranks(idx, E)
    fr = FusedRouting(idx, torch.ones(N, k, device=dev), pos, counts,
                      torch.zeros((), device=dev), torch.zeros((), device=dev))
    gd = grouped_dispatch_from_fused(fr, E)
    x = torch.randn(N, D, generator=g, device=dev)
    buf = dispatch_grouped(x, gd).to(dtype)
    wg = (torch.randn(E, D, F_, generator=g, device=dev) / D ** 0.5)
    wu = (torch.randn(E, D, F_, generator=g, device=dev) / D ** 0.5
          if activation == "swiglu" else None)
    wd = torch.randn(E, F_, D, generator=g, device=dev) / F_ ** 0.5
    return (buf, gd.tile_expert, wg.to(dtype),
            wu.to(dtype) if wu is not None else None, wd.to(dtype)), counts


def check_grouped(dev, dtype, N, cfg, label):
    args, counts = grouped_case(dev, dtype, N, cfg["D"], cfg["F"], cfg["E"],
                                cfg["k"], cfg["activation"])
    got = grouped_moe_ffn(*args, activation=cfg["activation"])
    want = grouped_moe_ref(*args, activation=cfg["activation"])
    torch.cuda.synchronize()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    check(ok, f"grouped {label} {dtype}: off by {max_abs(got, want)}")
    return max_abs(got, want), (args, counts)


def decode_case(dev, dtype, B, N, G, D, T, kv_len, valid, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(B, N, G, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, N, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, N, D, generator=g, device=dev).to(dtype)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    return q, k[:, :kv_len], v[:, :kv_len], vl   # strided ragged slices


def check_decode(dev, dtype, B, N, G, D, label, T=MAX_LEN, kv_len=32,
                 valid=(9, 17, 25, 32)):
    args = decode_case(dev, dtype, B, N, G, D, T, kv_len, valid)
    check(not args[1].is_contiguous(), "decode: the slice must be strided")
    got = decode_attention(*args)
    want = decode_attention_ref(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    check(ok, f"decode {label} {dtype}: off by {max_abs(got, want)}")
    return max_abs(got, want), args


def sdpa_of(q, k, v, vl):
    """The same attention as one PyTorch call (the yardstick, never used
    by the port): (B, H, 1, D) queries against (B, H, T, D) keys."""
    B, N, G, D = q.shape
    T = k.shape[1]
    qs = q.reshape(B, N * G, 1, D)
    ks = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vs = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    mask = (torch.arange(T, device=q.device)[None, :]
            < vl[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)


def time_router(timer, dev, cfg) -> Dict:
    err, (x, w, k) = check_router(dev, torch.float32, SLOTS, cfg["D"],
                                  cfg["E"], cfg["k"], "timed")
    N, D = x.shape
    E = w.shape[1]
    out_bytes = N * k * 4 * 3 + E * 4 + 2 * E * 4
    return {"max_abs_err": err,
            "ms": timer(lambda: router_topk_fused(x, w, k=k)),
            "host_ms": timer.host_ms(lambda: router_topk_fused(x, w, k=k)),
            "plain_ms": timer(lambda: router_topk_fused_ref(x, w, k=k)),
            "library_ms": None,
            **bound(nbytes(x, w) + out_bytes, 2 * N * D * E, torch.float32),
            "shape": f"N={N} D={D} E={E} k={k} float32"}


def time_grouped(timer, dev, cfg) -> Dict:
    act = cfg["activation"]
    err, (args, counts) = check_grouped(dev, torch.float32, SLOTS, cfg,
                                        "timed")
    buf, te, wg, wu, wd = args
    active = int((counts > 0).sum())
    n_mats = 3 if wu is not None else 2
    D, F_ = cfg["D"], cfg["F"]
    w_bytes = active * n_mats * D * F_ * 4          # only routed experts
    pairs = int(counts.sum())
    return {"max_abs_err": err,
            "ms": timer(lambda: grouped_moe_ffn(*args, activation=act)),
            "host_ms": timer.host_ms(
                lambda: grouped_moe_ffn(*args, activation=act)),
            "plain_ms": timer(lambda: grouped_moe_ref(*args, activation=act)),
            "library_ms": None,
            **bound(2 * nbytes(buf) + nbytes(te) + w_bytes,
                    2 * pairs * D * F_ * n_mats, torch.float32),
            "shape": f"pairs={pairs} rows={buf.shape[0]} D={D} F={F_} "
                     f"active_experts={active} {act} float32"}


def time_decode(timer, dev, cfg) -> Dict:
    err, args = check_decode(dev, torch.float32, SLOTS, cfg["heads"], 1,
                             cfg["hd"], "timed")
    q, k, v, vl = args
    lib = sdpa_of(*args)
    check(torch.allclose(lib().reshape(q.shape), decode_attention(*args),
                         rtol=3e-5, atol=3e-5), "SDPA yardstick disagrees")
    n_valid = int(vl.sum())
    N, D = q.shape[1], q.shape[3]
    kv_bytes = 2 * n_valid * N * D * 4              # valid K and V rows only
    return {"max_abs_err": err,
            "ms": timer(lambda: decode_attention(*args)),
            "host_ms": timer.host_ms(lambda: decode_attention(*args)),
            "plain_ms": timer(lambda: decode_attention_ref(*args)),
            "library_ms": timer(lib),
            **bound(2 * nbytes(q) + nbytes(vl) + kv_bytes,
                    4 * n_valid * N * q.shape[2] * D, torch.float32),
            "shape": f"B={q.shape[0]} N={N} G={q.shape[2]} D={D} "
                     f"kv_len={k.shape[1]} valid={vl.tolist()} float32"}


TIMERS = {"router_topk_fused": time_router, "grouped_moe_ffn": time_grouped,
          "decode_attention": time_decode}

# B4 at the runtime's shapes (E, C, D, F, activation): gpt2-moe's capture
# forward (8 x 128 tokens, capacity factor 1.25) and calibration buffers,
# qwen2-moe's capture forward; then ragged C and an all-zero buffer
CAPACITY_SHAPES = {
    "gpt2-capture": (4, 320, 768, 3072, "gelu"),
    "gpt2-calibrate": (4, 64, 768, 3072, "gelu"),
    "qwen2-capture": (60, 88, 2048, 1408, "swiglu"),
    "C12": (4, 12, 768, 3072, "gelu"),
    "zero": (4, 64, 768, 3072, "gelu"),
}


def capacity_case(dev, dtype, E, C, D, F_, activation, *, zero=False,
                  seed=0):
    """Capacity buffers with the last quarter of each expert's slots empty
    (or all of them), and fan-in scaled random expert weights."""
    g = torch.Generator(dev).manual_seed(seed)
    buf = torch.randn(E, C, D, generator=g, device=dev)
    buf[:, C - C // 4:] = 0.0
    if zero:
        buf.zero_()
    wg = torch.randn(E, D, F_, generator=g, device=dev) / D ** 0.5
    wu = (torch.randn(E, D, F_, generator=g, device=dev) / D ** 0.5
          if activation == "swiglu" else None)
    wd = torch.randn(E, F_, D, generator=g, device=dev) / F_ ** 0.5
    return (buf.to(dtype), wg.to(dtype),
            wu.to(dtype) if wu is not None else None, wd.to(dtype))


def check_capacity(dev, dtype, label):
    E, C, D, F_, act = CAPACITY_SHAPES[label]
    args = capacity_case(dev, dtype, E, C, D, F_, act, zero=label == "zero")
    got = capacity_ffn(*args, activation=act)
    want = capacity_ffn_ref(*args, activation=act)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    check(ok, f"capacity_ffn {label} {dtype}: off by {max_abs(got, want)}")
    empty = ~args[0].bool().any(-1)
    check(not bool(got[empty].any()),
          f"capacity_ffn {label} {dtype}: empty slots not exactly zero")
    return max_abs(got, want), float(want.float().abs().max()), (args, act)


def time_capacity(timer, dev, label, dtype=torch.float32) -> Dict:
    """B4 at one of the runtime's shapes. There is no one PyTorch call for
    the FFN; the plain version is three cuBLAS batched products (and the
    activation), so its time is also the library yardstick."""
    err, _, (args, act) = check_capacity(dev, dtype, label)
    buf, wg, wu, wd = args
    E, C, D = buf.shape
    F_ = wg.shape[-1]
    n_mats = 3 if wu is not None else 2
    weights = [w for w in (wg, wu, wd) if w is not None]
    plain_ms = timer(lambda: capacity_ffn_ref(*args, activation=act))
    return {"max_abs_err": err,
            "ms": timer(lambda: capacity_ffn(*args, activation=act)),
            "host_ms": timer.host_ms(lambda: capacity_ffn(*args,
                                                          activation=act)),
            "plain_ms": plain_ms, "library_ms": plain_ms,
            **bound(2 * nbytes(buf) + nbytes(*weights),
                    2 * E * C * D * F_ * n_mats, dtype),
            "shape": f"E={E} C={C} D={D} F={F_} {act} {dtype}"}


# B5 at the runtime's token count (8 x 128) with gpt2-moe's and
# qwen2-moe's router widths, a token count that is no multiple of 32,
# and a tie (experts 1 and 2 lead with identical columns)
GATING_CASES = {
    "gpt2": dict(N=1024, D=768, E=4, k=1, ve=None),
    "qwen2": dict(N=1024, D=2048, E=60, k=4, ve=60),
    "qwen2-padded-N1000": dict(N=1000, D=2048, E=60, k=4, ve=60),
    "tie": dict(N=1000, D=768, E=8, k=2, ve=None),
}


def check_gating(dev, dtype, label):
    c = GATING_CASES[label]
    x, w = router_case(dev, dtype, c["N"], c["D"], c["E"], c["k"],
                       tie=label == "tie")
    got = router_topk(x, w, k=c["k"], valid_experts=c["ve"])
    want = router_topk_ref(x, w, k=c["k"], valid_experts=c["ve"])
    torch.cuda.synchronize()
    check(torch.equal(got[1], want[1]), f"router_topk {label} {dtype}: "
          "indices differ")
    err = max_abs(got[0], want[0])
    check(err <= ROUTER_FLOAT_TOL, f"router_topk {label} {dtype}: weights "
          f"off by {err}")
    if label == "tie":
        check(bool((got[1][:, :2] == torch.tensor([1, 2], device=dev)
                    ).all()), "router_topk tie: lowest index must win")
    return err, (x, w, c)


def time_gating(timer, dev, label="gpt2") -> Dict:
    err, (x, w, c) = check_gating(dev, torch.float32, label)
    N, D = x.shape
    E, k, ve = w.shape[1], c["k"], c["ve"]
    return {"max_abs_err": err,
            "ms": timer(lambda: router_topk(x, w, k=k, valid_experts=ve)),
            "host_ms": timer.host_ms(
                lambda: router_topk(x, w, k=k, valid_experts=ve)),
            "plain_ms": timer(
                lambda: router_topk_ref(x, w, k=k, valid_experts=ve)),
            "library_ms": None,
            **bound(nbytes(x, w) + N * k * 8, 2 * N * D * E, torch.float32),
            "shape": f"N={N} D={D} E={E} k={k} float32"}


def phase_kernels(dev) -> Dict[str, Dict]:
    """Correctness at every shape and dtype; times at the decode shapes of
    both models (gpt2-moe's go into the kernel table)."""
    cases: List[Dict] = []
    for dtype in DTYPES:
        for label, N, cfg in (("gpt2-decode", SLOTS, GPT2),
                              ("gpt2-prefill", 16, GPT2),
                              ("qwen2-decode", SLOTS, QWEN2),
                              ("qwen2-prefill", 16, QWEN2),
                              ("qwen2-padded-N100", 100, QWEN2)):
            err, _ = check_router(dev, dtype, N, cfg["D"], cfg["E"],
                                  cfg["k"], label)
            cases.append({"kernel": "router_topk_fused", "case": label,
                          "dtype": str(dtype), "max_abs_err": err})
        err, _ = check_router(dev, dtype, 64, 768, 8, 2, "tie", tie=True)
        cases.append({"kernel": "router_topk_fused", "case": "tie",
                      "dtype": str(dtype), "max_abs_err": err})
        for label, N, cfg in (("gpt2-decode", SLOTS, GPT2),
                              ("gpt2-prefill", 16, GPT2),
                              ("qwen2-decode", SLOTS, QWEN2),
                              ("qwen2-prefill", 16, QWEN2)):
            err, _ = check_grouped(dev, dtype, N, cfg, label)
            cases.append({"kernel": "grouped_moe_ffn", "case": label,
                          "dtype": str(dtype), "max_abs_err": err})
        for label, N, G, D in (("gpt2", 12, 1, 64), ("qwen2", 16, 1, 128),
                               ("gqa-G4", 4, 4, 64)):
            err, _ = check_decode(dev, dtype, SLOTS, N, G, D, label)
            cases.append({"kernel": "decode_attention", "case": label,
                          "dtype": str(dtype), "max_abs_err": err})
        # a row with no valid slot: the mean of V over the rows passed in
        err, _ = check_decode(dev, dtype, SLOTS, 12, 1, 64, "valid0",
                              valid=(0, 17, 25, 32))
        cases.append({"kernel": "decode_attention", "case": "valid0",
                      "dtype": str(dtype), "max_abs_err": err})
        for label in CAPACITY_SHAPES:
            err, ref_max, _ = check_capacity(dev, dtype, label)
            cases.append({"kernel": "capacity_ffn", "case": label,
                          "dtype": str(dtype), "max_abs_err": err,
                          "max_abs_plain": ref_max})
        for label in GATING_CASES:
            err, _ = check_gating(dev, dtype, label)
            cases.append({"kernel": "router_topk", "case": label,
                          "dtype": str(dtype), "max_abs_err": err})
    timer = ColdTimer(dev)
    timed = {model: {name: fn(timer, dev, cfg) for name, fn in TIMERS.items()}
             for model, cfg in (("gpt2-moe", GPT2), ("qwen2-moe", QWEN2))}
    timed["gpt2-moe"]["capacity_ffn"] = time_capacity(timer, dev,
                                                      "gpt2-capture")
    timed["gpt2-moe"]["router_topk"] = time_gating(timer, dev, "gpt2")
    timed["capacity_ffn"] = {
        f"{label} {dtype}": time_capacity(timer, dev, label, dtype)
        for label, dtype in (("gpt2-calibrate", torch.float32),
                             ("qwen2-capture", torch.float32),
                             ("gpt2-capture", torch.bfloat16))}
    emit("kernels", cases=cases, timed=timed,
         timing="device ms: CUDA events around single calls, L2 flushed "
                f"before each, {timer.iters} calls after 3 warm-up calls, "
                "host enqueue hidden behind a spin kernel; host_ms: wall "
                "per synchronised call")
    return timed["gpt2-moe"]


# ------------------------------------------------------------------ serving

class TimedModel(Model):
    """The port's Model with the wall time of each prefill and decode step
    recorded (synchronised, so device work is inside the window)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    def _timed(self, fn, sink, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    def prefill(self, *a, **kw):
        return self._timed(super().prefill, self.prefill_s, *a, **kw)

    def decode_step(self, *a, **kw):
        return self._timed(super().decode_step, self.decode_s, *a, **kw)


def check_logits_on_cpu(model: Model, params, prompt: np.ndarray) -> float:
    """The first prompt's last-token prefill logits: the card (kernels)
    against the plain path on the CPU, same float32 weights."""
    with torch.no_grad():
        toks = torch.as_tensor(prompt[None])
        gpu, _ = model.prefill(params, toks)
        cpu_model = Model(model.cfg, device="cpu", moe_executor="grouped")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu, _ = cpu_model.prefill(cpu_params, toks)
    err = float((gpu[0, -1].cpu() - cpu[0, -1]).abs().max())
    check(err <= 1e-3, f"prefill logits off the CPU plain path by {err}")
    return err


def phase_serve(dev, phase: str, cfg, *,
                logits_check: bool) -> Dict[str, int]:
    t0 = time.perf_counter()
    model = TimedModel(cfg, device=dev, moe_executor="grouped")
    params = model.init_params(torch.Generator(dev).manual_seed(0),
                               torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 17, size=6)]
    logits_err = (check_logits_on_cpu(model, params, prompts[0])
                  if logits_check else None)
    totals: Dict[str, int] = {name: 0 for name in KERNELS}
    runs = []
    for telemetry in (True, False):
        eng = ServingEngine(model, params, max_len=MAX_LEN,
                            batch_size=SLOTS, collect_telemetry=telemetry,
                            device=dev)
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        model.prefill_s.clear()
        model.decode_s.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t_run = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        counts = launch_counts()
        for name, n in counts.items():
            totals[name] += n
        check(all(r.finish_reason == "length" and
                  len(r.output) == NEW_TOKENS for r in reqs),
              f"{phase}: not every request finished")
        check(counts["router_topk_fused"] > 0 and
              counts["grouped_moe_ffn"] > 0,
              f"{phase}: router/grouped kernels not launched: {counts}")
        if telemetry:
            tel = eng.telemetry
            check(tel.demand_matrix().sum() == tel.total_tokens
                  * cfg.moe.top_k * cfg.num_layers,
                  f"{phase}: demand matrix does not add up")
        else:
            check(counts["decode_attention"] > 0,
                  f"{phase}: flash-decode not launched: {counts}")
        decode_tokens = sum(len(r.output) - 1 for r in reqs)
        runs.append({
            "telemetry": telemetry,
            "launches": counts,
            "prefills": len(model.prefill_s),
            "decode_steps": len(model.decode_s),
            "ttft_ms_mean": 1e3 * float(np.mean([r.ttft_s for r in reqs])),
            "ttft_ms_first_slots": 1e3 * float(np.mean(
                [r.ttft_s for r in reqs[:SLOTS]])),
            "prefill_ms_mean": 1e3 * float(np.mean(model.prefill_s)),
            "decode_step_ms_mean": 1e3 * float(np.mean(model.decode_s)),
            "decode_tokens_per_s": decode_tokens / sum(model.decode_s),
            "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "outputs_first": reqs[0].output,
        })
    profiles = [profiled_run(model, params, prompts, telemetry, dev)
                for telemetry in (True, False)]
    emit(phase, model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
         params=n_params, init_s=init_s, logits_max_abs_err=logits_err,
         runs=runs, profiles=profiles)
    del model, params
    torch.cuda.empty_cache()
    return totals


def profiled_run(model, params, prompts, telemetry: bool, dev) -> Dict:
    """The same serving run under ``torch.profiler``: the device's busy
    time (sum of the device events, one stream) against the run's wall
    time, and the kernels that took most of it. The profiler's own cost
    inflates the wall time, so the idle share is an upper bound."""
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=SLOTS,
                        collect_telemetry=telemetry, device=dev)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"telemetry": telemetry, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if by_name else None,
            "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
            "device_events": len(by_name),
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


# ------------------------------------------------------------------ runtime

RUNTIME = dict(batch_size=8, seq_len=128, profile_batches=4, learn_batches=1,
               eval_batches=1)


def add_counts(totals: Dict[str, int]) -> Dict[str, int]:
    """Add the launches since the last reset to ``totals``; return them."""
    counts = launch_counts()
    for name, n in counts.items():
        totals[name] += n
    return counts


def check_capture_on_cpu(rt: ServerlessMoERuntime,
                         tokens: np.ndarray) -> float:
    """One capture forward's logits: the card (kernels) against the plain
    path on the CPU, same float32 weights, dense executor on both."""
    with torch.inference_mode():
        toks = torch.as_tensor(tokens)
        gpu = rt.model.forward(rt.params, toks, capture=True)[0]
        cpu_model = Model(rt.cfg, device="cpu")
        cpu_params = tree_map(lambda t: t.cpu(), rt.params)
        cpu = cpu_model.forward(cpu_params, toks, capture=True)[0]
    err = float((gpu.cpu() - cpu).abs().max())
    check(err <= 1e-3, f"capture logits off the CPU plain path by {err}")
    return err


def phase_runtime(dev) -> Dict[str, int]:
    """The runtime loop of examples/serve_moe_serverless.py (steps 1-3) on
    full-width gpt2-moe: calibrate, profile, BO plan, bill, serve,
    re-plan. Launch counts are read around each step that drives the
    path; the CPU comparison runs outside those windows."""
    totals: Dict[str, int] = {name: 0 for name in KERNELS}
    rc = RuntimeConfig(arch="gpt2-moe", reduced=False, **RUNTIME)
    reset_launch_counts()
    t0 = time.perf_counter()
    rt = ServerlessMoERuntime(rc, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    calib = add_counts(totals)
    check(calib["capacity_ffn"] == 6,
          f"runtime: calibrate_u_ref launched B4 {calib['capacity_ffn']}x")
    L, k = rt.num_layers, rt.top_k
    forwards = rc.profile_batches

    reset_launch_counts()
    t0 = time.perf_counter()
    table = rt.profile_table()
    profile_s = time.perf_counter() - t0
    prof = add_counts(totals)
    for name in ("capacity_ffn", "router_topk_fused"):
        check(prof[name] == forwards * L,
              f"runtime: {name} launched {prof[name]}x in {forwards} "
              f"capture forwards of {L} layers")
    demand = table.demand_matrix()
    check(demand.sum() == forwards * rc.batch_size * rc.seq_len * k * L,
          "runtime: profiled demand does not add up")

    first = next(iter(rt.corpus.batches(1)))["tokens"]
    logits_err = check_capture_on_cpu(rt, first)

    reset_launch_counts()
    t0 = time.perf_counter()
    plan = rt.plan_bo(Q=40, max_iters=4, seed=0)
    bo_s = time.perf_counter() - t0
    add_counts(totals)
    sim = rt.simulator_backend().execute(
        plan, Workload(batches=rt.eval_batches()))
    check(np.isfinite(sim.billed_cost) and sim.billed_cost > 0,
          f"runtime: simulator billed {sim.billed_cost}")

    engine = ServingEngine(rt.model, rt.params, max_len=MAX_LEN,
                           batch_size=SLOTS,
                           predictor=rt.online_predictor(decay=0.98))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rt.cfg.vocab_size, size=int(n)).astype(
        np.int32) for n in rng.integers(8, 17, size=6)]
    reset_launch_counts()
    t0 = time.perf_counter()
    served = rt.serving_backend(engine).execute(
        plan, Workload(batches=prompts, max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = add_counts(totals)
    check(served.extras["finish_reasons"] == ["length"] * len(prompts),
          f"runtime: finish reasons {served.extras['finish_reasons']}")
    check(np.isfinite(served.billed_cost) and served.billed_cost > 0,
          f"runtime: serving backend billed {served.billed_cost}")
    check(serve_counts["router_topk_fused"] > 0 and
          serve_counts["grouped_moe_ffn"] > 0,
          f"runtime: serving launched {serve_counts}")

    replan = rt.plan_from_telemetry(engine.telemetry)
    check("replan_diff" in replan.metadata,
          "runtime: the re-plan carries no replan_diff")
    emit("runtime_gpt2", model=rt.cfg.name, layers=L,
         d_model=rt.cfg.d_model, experts=rt.num_experts, top_k=k,
         **RUNTIME, init_s=init_s,
         u_ref_measured_s=rt.u_ref_measured_s,
         u_ref_s=rt.profile.u_ref_s,
         profile_s=profile_s, capture_forward_ms=profile_s / forwards * 1e3,
         capture_logits_max_abs_err=logits_err,
         table_entries=len(table.counts),
         bo_s=bo_s, bo=plan.metadata["bo"],
         plan_methods=plan.method.tolist(),
         simulator_billed_cost=sim.billed_cost,
         serving_billed_cost=served.billed_cost,
         serving_wall_s=serve_s,
         serving_mean_ttft_s=served.extras["mean_ttft_s"],
         replan_methods=replan.method.tolist(),
         launches={"calibrate": calib, "profile": prof,
                   "serving": serve_counts, "total": totals})
    del rt, engine
    torch.cuda.empty_cache()
    return totals


# --------------------------------------------------------------------- main

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit("build", seconds=build_s, sources=[s.name for s in _build.sources()],
         directory=str(_build.build_dir().relative_to(ROOT)))

    timed = phase_kernels(dev)

    qwen2 = dataclasses.replace(get_arch("qwen2-moe-a2.7b"), num_layers=2)
    by_phase = {
        "serve_gpt2": phase_serve(dev, "serve_gpt2", get_arch("gpt2-moe"),
                                  logits_check=True),
        "serve_qwen2": phase_serve(dev, "serve_qwen2", qwen2,
                                   logits_check=False),
        "runtime_gpt2": phase_runtime(dev),
    }

    rows = []
    for name, k in KERNELS.items():
        t = timed[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces,
                     "launches": sum(c[name] for c in by_phase.values()),
                     "path": [ph for ph, c in by_phase.items() if c[name]],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "shape": t["shape"]})
    for r in rows:
        if r["name"] in OFF_PATH:
            emit("launch_check", kernel=r["name"], exempt=OFF_PATH[r["name"]])
        else:
            check(r["launches"] > 0, f"{r['name']} never launched on a path")
    emit("done", seconds=time.perf_counter() - t0)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
