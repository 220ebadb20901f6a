#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

Run from the root of a checkout (it needs one CUDA device)::

    python3 chip_smoke.py

It imports only ``repro_torch`` (from ``src/``), torch and numpy, and
prints one JSON line per phase:

1. ``build``: compile every kernel of ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (one process per source, all at once); then ``sass``:
   ``cuobjdump -sass`` of the capacity FFN library and of the grouped FFN
   library (its long-group path) must show tensor-core instructions
   (``HGMMA`` or ``HMMA``).
2. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, in float32 and bfloat16, at the serving path's
   shapes (gpt2-moe: D 768, F 3072, E 4, k 1, GELU; qwen2-moe-a2.7b:
   D 2048, F 1408, E 60, k 4, SwiGLU), plus a padded token count and a
   tie for the router and a GQA case (4 query heads per KV head) for
   flash-decode. Integers must be equal; floats within the kernel
   harness's bounds (f32 3e-5, bf16 2e-2; the router's float outputs
   1e-5). Times come from CUDA events around single calls with the 50 MB
   L2 cache flushed before each (the serving path meets every layer's
   weights cold): ``ms`` after a 64 MiB write, and for the grouped FFN
   also ``ms_clean`` after a 64 MiB read (a clean L2, as a layer meets it
   after the previous layer's weight stream), beside ``stream_ms`` and
   ``stream_ms_clean``, one ``torch.sum`` over as many bytes as the
   grouped FFN must read. The fused router is also timed at the runtime's
   1024-token capture batch, the grouped FFN in bfloat16, at gpt2-moe
   prompts of 16, 128 and 512 tokens and at a 128-token qwen2-moe prompt
   (with the path its plan takes), and flash-decode at a long cache that
   it splits across blocks. The ticket workspace of the fused router, which merges
   its split work inside its one launch, must be all zero afterwards
   (and again at the end).
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
   against the plain path on the CPU; both bills must equal the ones
   recorded in ``BILLS``.
6. ``launch_ops``: ``torch.profiler`` counts the CUDA operations of one
   wrapper call at the paths' shapes, in a second process of this script
   (``--launch-ops``) started after the other phases; each count must
   equal ``DEVICE_OPS_PER_CALL`` (the fused router one launch, the
   grouped FFN two). No profiler session runs before the timed serving
   runs (each serving phase profiles only after its timed runs).

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
import re
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
from repro_torch.kernels import (KERNELS, _build,  # noqa: E402
                                 device_ops_per_call, launch_counts,
                                 reset_launch_counts, workspace_is_zero)
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.expert_ffn.ops import capacity_ffn  # noqa: E402
from repro_torch.kernels.expert_ffn.ref import capacity_ffn_ref  # noqa: E402
from repro_torch.kernels._common import sm_count  # noqa: E402
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

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by operand type.
# float32 operands count at the tensor cores' TF32 rate (495 TFLOP/s), not
# the 67 TFLOP/s of the CUDA cores: the card can multiply float32 data
# there (the capacity FFN does, as 3xTF32), so the least time the card
# could take for float32 work is set by that rate. bfloat16 on the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 495e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
ROUTER_FLOAT_TOL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
GPT2 = dict(D=768, F=3072, E=4, k=1, activation="gelu", heads=12, hd=64)
QWEN2 = dict(D=2048, F=1408, E=60, k=4, activation="swiglu", heads=16,
             hd=128)
SLOTS, MAX_LEN, NEW_TOKENS = 4, 128, 8
GROUPED_PROMPTS = (16, 128, 512)   # B2's timed gpt2-moe prompt lengths
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
    events after the inputs have been pushed out of the 50 MB L2 cache.
    A spin kernel queued first keeps the device busy while the host
    enqueues every call, so the events bracket device work, not the
    wrapper's host overhead (``host_ms`` measures that: wall per call,
    synchronised). A call that synchronises itself (the plain grouped FFN
    reads ``tile_expert`` on the host) still shows its host time.

    Two flushes. The default *writes* 64 MiB (``zero_``): it leaves the
    L2 full of dirty lines, which are written back while the timed call
    reads. ``clean=True`` *reads* another 64 MiB (a sum into one value),
    so the timed call finds the L2 clean, as a layer does after the
    previous layer's weight stream (which read much and wrote little)."""

    SPIN_CYCLES = 200_000_000        # about 0.1 s at the H100's clock

    def __init__(self, device: torch.device, iters: int = 20):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.clean_flush = torch.ones(16 << 20, dtype=torch.float32,
                                      device=device)
        self.sink = torch.empty((), dtype=torch.float32, device=device)
        self.iters = iters

    def _flush(self, clean: bool) -> None:
        if clean:
            torch.sum(self.clean_flush, 0, out=self.sink)
        else:
            self.flush.zero_()

    def __call__(self, fn: Callable[[], object], clean: bool = False) -> float:
        for _ in range(3):
            self._flush(clean)
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.iters)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for start, end in pairs:
            self._flush(clean)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / self.iters

    def stream(self, tensors, clean: bool = False) -> float:
        """ms of one ``torch.sum`` over as many bytes as ``tensors`` hold,
        copied into one buffer first: the time a plain read of those bytes
        takes (a yardstick, as ``library_ms`` is; no kernel of the port)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        out = torch.empty((), dtype=flat.dtype, device=flat.device)
        ms = self(lambda: torch.sum(flat, 0, out=out), clean=clean)
        del flat
        return ms

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


def time_router(timer, dev, cfg, N=SLOTS) -> Dict:
    err, (x, w, k) = check_router(dev, torch.float32, N, cfg["D"],
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


def grouped_stream_tensors(args, counts):
    """What B2 must read: the routed experts' weight matrices and x."""
    buf, _, wg, wu, wd = args
    active = [e for e in range(len(counts)) if int(counts[e]) > 0]
    return [w[e] for w in (wg, wu, wd) if w is not None
            for e in active] + [buf]


def time_grouped(timer, dev, cfg, N=SLOTS, dtype=torch.float32) -> Dict:
    act = cfg["activation"]
    err, (args, counts) = check_grouped(dev, dtype, N, cfg, "timed")
    buf, te, wg, wu, wd = args
    active = int((counts > 0).sum())
    n_mats = 3 if wu is not None else 2
    D, F_ = cfg["D"], cfg["F"]
    # only the routed experts' weights, each read once
    w_bytes = active * n_mats * D * F_ * wg.element_size()
    pairs = int(counts.sum())
    fn = lambda: grouped_moe_ffn(*args, activation=act)  # noqa: E731
    stream = grouped_stream_tensors(args, counts)
    # imported here: scripts/compare_checkout.py imports this module over
    # an earlier checkout's package, which may have no plan function
    from repro_torch.kernels.grouped_moe.ops import grouped_plan
    plan = grouped_plan(buf.shape[0], D, F_, wg.shape[0], dtype,
                        wu is not None, sm_count(dev))
    return {"max_abs_err": err,
            "ms": timer(fn), "ms_clean": timer(fn, clean=True),
            "stream_ms": timer.stream(stream),
            "stream_ms_clean": timer.stream(stream, clean=True),
            "host_ms": timer.host_ms(fn),
            "plain_ms": timer(lambda: grouped_moe_ref(*args, activation=act)),
            "library_ms": None, "kernel_path": plan.path,
            **bound(2 * nbytes(buf) + nbytes(te) + w_bytes,
                    2 * pairs * D * F_ * n_mats, dtype),
            "shape": f"N={N} pairs={pairs} rows={buf.shape[0]} D={D} "
                     f"F={F_} active_experts={active} "
                     f"max_rows_per_expert={int(counts.max())} {act} "
                     f"{str(dtype)[6:]}"}


# a long cache on few (batch row, kv head) blocks: B3 splits it across
# blocks (split-KV) and merges the splits inside the launch
LONG_DECODE = dict(B=2, N=2, G=1, D=128, T=4160, kv_len=4096,
                   valid=(3000, 4096))


def time_decode(timer, dev, cfg, long=False) -> Dict:
    if long:
        c = LONG_DECODE
        err, args = check_decode(dev, torch.float32, c["B"], c["N"], c["G"],
                                 c["D"], "long", T=c["T"],
                                 kv_len=c["kv_len"], valid=c["valid"])
    else:
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
                              *((f"gpt2-prefill-N{n}", n, GPT2)
                                for n in GROUPED_PROMPTS),
                              ("qwen2-decode", SLOTS, QWEN2),
                              ("qwen2-prefill", 16, QWEN2),
                              ("qwen2-prefill-N128", 128, QWEN2)):
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
    # B1 at the runtime's capture batch (8 x 128 tokens), beside its decode
    # time; B3 on a long cache, split across blocks
    timed["router_topk_fused"] = {
        "gpt2-moe capture N=1024": time_router(timer, dev, GPT2, N=1024)}
    # B2 beside its decode times: bf16, prompts of 16, 128 and 512 tokens
    # (gpt2-moe top-1: about 4, 32 and 128 rows per expert) and qwen2-moe
    # at 128 tokens (512 pairs over 60 experts: short groups)
    timed["grouped_moe_ffn"] = {
        "gpt2-moe decode bfloat16": time_grouped(timer, dev, GPT2,
                                                 dtype=torch.bfloat16),
        **{f"gpt2-moe prefill N={n}": time_grouped(timer, dev, GPT2, N=n)
           for n in GROUPED_PROMPTS},
        "qwen2-moe prefill N=128": time_grouped(timer, dev, QWEN2, N=128)}
    timed["decode_attention"] = {
        "split-kv": time_decode(timer, dev, None, long=True)}
    timed["capacity_ffn"] = {
        f"{label} {dtype}": time_capacity(timer, dev, label, dtype)
        for label, dtype in (("gpt2-calibrate", torch.float32),
                             ("qwen2-capture", torch.float32),
                             ("gpt2-capture", torch.bfloat16))}
    emit("kernels", cases=cases, timed=timed,
         timing="device ms: CUDA events around single calls, L2 flushed "
                "before each (ms: 64 MiB written; ms_clean: 64 MiB read), "
                f"{timer.iters} calls after 3 warm-up calls, host enqueue "
                "hidden behind a spin kernel; host_ms: wall per "
                "synchronised call")
    check(workspace_is_zero(), "ticket workspace not all zero after the "
                               "kernels phase")
    return timed["gpt2-moe"]


# CUDA operations (kernels, memsets, copies) one wrapper call issues: the
# fused router merges its slices and tiles inside one launch; the grouped
# FFN launches up and down (split merges inside clusters); the capacity
# FFN launches up, down and a reduce of the split down product
DEVICE_OPS_PER_CALL = {"router_topk_fused": 1, "grouped_moe_ffn": 2,
                       "decode_attention": 1, "capacity_ffn": 3,
                       "router_topk": 1}


def ops_per_call(dev) -> Dict[str, Dict[str, int]]:
    """CUDA operations per wrapper call (``torch.profiler``) at the serving
    path's shapes of both models, and at the runtime's 1024-token batch
    for the routers."""
    ops: Dict[str, Dict[str, int]] = {}
    for model, cfg in (("gpt2-moe", GPT2), ("qwen2-moe", QWEN2)):
        for label, N in (("decode", SLOTS), ("prefill", 16),
                         ("prefill N=128", 128)):
            x, w = router_case(dev, torch.float32, N, cfg["D"], cfg["E"],
                               cfg["k"])
            args, _ = grouped_case(dev, torch.float32, N, cfg["D"], cfg["F"],
                                   cfg["E"], cfg["k"], cfg["activation"])
            act, k = cfg["activation"], cfg["k"]
            key = f"{model} {label}"
            ops.setdefault("router_topk_fused", {})[key] = \
                device_ops_per_call(lambda: router_topk_fused(x, w, k=k))
            ops.setdefault("grouped_moe_ffn", {})[key] = device_ops_per_call(
                lambda: grouped_moe_ffn(*args, activation=act))
            del args
    args, _ = grouped_case(dev, torch.float32, 512, GPT2["D"], GPT2["F"],
                           GPT2["E"], GPT2["k"], GPT2["activation"])
    ops["grouped_moe_ffn"]["gpt2-moe prefill N=512"] = device_ops_per_call(
        lambda: grouped_moe_ffn(*args, activation=GPT2["activation"]))
    del args
    for label in ("gpt2", "qwen2"):
        c = GATING_CASES[label]
        x, w = router_case(dev, torch.float32, c["N"], c["D"], c["E"],
                           c["k"])
        ops["router_topk_fused"][f"{label} N={c['N']}"] = device_ops_per_call(
            lambda: router_topk_fused(x, w, k=c["k"]))
        ops.setdefault("router_topk", {})[f"{label} N={c['N']}"] = \
            device_ops_per_call(lambda: router_topk(x, w, k=c["k"]))
    args = decode_case(dev, torch.float32, SLOTS, GPT2["heads"], 1,
                       GPT2["hd"], MAX_LEN, 32, (9, 17, 25, 32))
    ops["decode_attention"] = {"gpt2-moe decode": device_ops_per_call(
        lambda: decode_attention(*args))}
    E, C, D, F_, act = CAPACITY_SHAPES["gpt2-capture"]
    cargs = capacity_case(dev, torch.float32, E, C, D, F_, act)
    ops["capacity_ffn"] = {"gpt2-capture": device_ops_per_call(
        lambda: capacity_ffn(*cargs, activation=act))}
    return ops


LAUNCH_OPS_FLAG = "--launch-ops"


def phase_launch_ops() -> None:
    """``ops_per_call`` in a fresh process of this script: in the process
    that has run the profiled serving runs and the runtime loop,
    ``torch.profiler`` records no CUDA operation (seen on the H100), and
    a profiling session is not run before the timed serving runs either,
    since it slows every later launch from the host."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          LAUNCH_OPS_FLAG], capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"launch_ops: the counting process exited "
                               f"{out.returncode}: {out.stderr[-2000:]}")
    ops = json.loads(out.stdout.strip().splitlines()[-1])
    emit("launch_ops", device_ops_per_call=ops)
    for name, want in DEVICE_OPS_PER_CALL.items():
        for label, n in ops[name].items():
            check(n == want, f"{name} {label}: {n} CUDA operations per "
                             f"call, expected {want}")


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


# The plan's billed cost (GB-s priced as AWS Lambda) with seed 0 weights
# and prompts; u_ref_s is clamped to 1e-5 on the H100, so the bills do not
# depend on the card's speed, only on the plan and the routed demand.
BILLS = {"simulator": 3.0935478537500005e-05,
         "serving": 2.6708740754614253e-05}


def check_bill(backend: str, cost: float) -> None:
    want = BILLS[backend]
    check(np.isfinite(cost) and abs(cost - want) <= 1e-9 * want,
          f"runtime: {backend} backend billed {cost!r}, expected {want!r}")


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
    check_bill("simulator", sim.billed_cost)

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
    check_bill("serving", served.billed_cost)
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

def tensor_core_instructions(name: str) -> Dict[str, int]:
    """Counts of tensor-core instructions (HGMMA, HMMA by shape and type)
    in the SASS of the built lib<name>.so, from ``cuobjdump -sass``."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    lib = _build.build_dir() / f"lib{name}.so"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts: Dict[str, int] = {}
    for m in re.finditer(r"\b(HGMMA|HMMA)\.[0-9A-Za-z.]+", out):
        counts[m.group(0)] = counts.get(m.group(0), 0) + 1
    return counts


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
    if LAUNCH_OPS_FLAG in sys.argv[1:]:
        print(json.dumps(ops_per_call(dev)), flush=True)
        return 0

    t0 = time.perf_counter()
    build_s = _build.build_all()
    emit("build", seconds=build_s, sources=[s.name for s in _build.sources()],
         directory=str(_build.build_dir().relative_to(ROOT)))
    for lib, what in (("expert_ffn", "capacity FFN"),
                      ("grouped_moe", "grouped FFN")):
        tc = tensor_core_instructions(lib)
        emit("sass", library=f"lib{lib}.so", tensor_core_instructions=tc)
        check(sum(tc.values()) > 0, f"{what}: no HGMMA/HMMA in its SASS")

    timed = phase_kernels(dev)

    qwen2 = dataclasses.replace(get_arch("qwen2-moe-a2.7b"), num_layers=2)
    by_phase = {
        "serve_gpt2": phase_serve(dev, "serve_gpt2", get_arch("gpt2-moe"),
                                  logits_check=True),
        "serve_qwen2": phase_serve(dev, "serve_qwen2", qwen2,
                                   logits_check=False),
        "runtime_gpt2": phase_runtime(dev),
    }
    phase_launch_ops()

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
                     "shape": t["shape"],
                     **{f: t[f] for f in ("ms_clean", "stream_ms",
                                          "stream_ms_clean", "kernel_path")
                        if f in t}})
    for r in rows:
        if r["name"] in OFF_PATH:
            emit("launch_check", kernel=r["name"], exempt=OFF_PATH[r["name"]])
        else:
            check(r["launches"] > 0, f"{r['name']} never launched on a path")
    check(workspace_is_zero(), "ticket workspace not all zero at the end")
    emit("done", seconds=time.perf_counter() - t0)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
