#!/usr/bin/env python3
"""Time one checkout's fused router (B1), grouped expert FFN (B2) and
gpt2-moe serving on one GPU, for a same-call comparison of two commits.

Unpack the earlier commit with ``git archive`` into a directory that
``.gitignore`` lists, then run, from the root of a checkout on a machine
with a CUDA device, parent and change alternately on the same card::

    for r in DIR . . DIR; do python3 scripts/compare_checkout.py --root $r; done

It takes ``chip_smoke.py`` and ``src/`` from ``--root`` (default: this
checkout), builds that checkout's kernels, and prints JSON lines:

- ``kernels``: B2 at gpt2-moe decode, a 128-token gpt2-moe prompt and
  qwen2-moe decode, and B1 at gpt2-moe decode, qwen2-moe decode and 1024
  tokens, each as device ms per call (``chip_smoke.ColdTimer``: CUDA
  events, L2 flushed before each call) and host ms per synchronised
  call;
- ``serve_gpt2``: ``chip_smoke.phase_serve`` on full-width gpt2-moe (its
  timed runs with and without telemetry, then its profiled runs); with
  ``--profiler-first``, 30 ``torch.profiler`` windows of one router call
  each are opened before it, as a launch count by the profiler would;
- ``summary``: the decode step and TTFT of both timed serving runs;

and, last, the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                help="checkout whose chip_smoke.py and src/ are timed")
ap.add_argument("--profiler-first", action="store_true",
                help="open 30 torch.profiler windows before serving")
ARGS = ap.parse_args()
ROOT = Path(ARGS.root).resolve()
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import get_arch  # noqa: E402

GROUPED = [("gpt2-moe decode", cs.GPT2, cs.SLOTS),
           ("gpt2-moe prefill N=128", cs.GPT2, 128),
           ("qwen2-moe decode", cs.QWEN2, cs.SLOTS)]
ROUTER = [("gpt2-moe decode", cs.GPT2, cs.SLOTS),
          ("qwen2-moe decode", cs.QWEN2, cs.SLOTS),
          ("gpt2-moe N=1024", cs.GPT2, 1024)]
PROFILER_WINDOWS = 30


def kernels(dev) -> dict:
    timer = cs.ColdTimer(dev)
    out: dict = {"grouped_moe_ffn": {}, "router_topk_fused": {}}
    for label, cfg, N in GROUPED:
        args, _ = cs.grouped_case(dev, torch.float32, N, cfg["D"], cfg["F"],
                                  cfg["E"], cfg["k"], cfg["activation"])
        fn = lambda: cs.grouped_moe_ffn(  # noqa: E731
            *args, activation=cfg["activation"])
        out["grouped_moe_ffn"][label] = {"ms": timer(fn),
                                         "host_ms": timer.host_ms(fn)}
        del args
    for label, cfg, N in ROUTER:
        t = cs.time_router(timer, dev, cfg, N=N)
        out["router_topk_fused"][label] = {"ms": t["ms"],
                                           "host_ms": t["host_ms"]}
    return out


def open_profiler_windows(dev) -> None:
    cfg = cs.GPT2
    x, w = cs.router_case(dev, torch.float32, cs.SLOTS, cfg["D"], cfg["E"],
                          cfg["k"])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_WINDOWS):
        with torch.profiler.profile(activities=acts):
            cs.router_topk_fused(x, w, k=cfg["k"])
            torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_checkout: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs._build.build_all()
    print(json.dumps({"root": str(ROOT), "kernels": kernels(dev)}),
          flush=True)
    if ARGS.profiler_first:
        open_profiler_windows(dev)
    caught: list = []   # the fields of the serve_gpt2 line
    emit = cs.emit
    cs.emit = lambda phase, **f: (caught.append(f), emit(phase, **f))
    cs.phase_serve(dev, "serve_gpt2", get_arch("gpt2-moe"),
                   logits_check=False)
    cs.emit = emit
    runs = caught[-1]["runs"]
    print(json.dumps({"summary": {
        "root": str(ROOT), "profiler_first": ARGS.profiler_first,
        **{f"telemetry_{'on' if r['telemetry'] else 'off'}": {
            k: r[k] for k in ("decode_step_ms_mean", "ttft_ms_mean",
                              "prefill_ms_mean", "wall_s")}
           for r in runs}}}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
