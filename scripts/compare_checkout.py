#!/usr/bin/env python3
"""Time one checkout's grouped expert FFN (B2), capacity FFN (B4), fused
router (B1) and gpt2-moe serving on one GPU, for a same-call comparison
of two commits.

Unpack the earlier commit with ``git archive`` into a directory that
``.gitignore`` lists, then run, from the root of a checkout on a machine
with a CUDA device, parent and change alternately on the same card::

    for r in DIR . . DIR; do python3 scripts/compare_checkout.py --root $r; done

It takes ``src/`` (the kernels and the model) from ``--root`` (default:
this checkout), builds that checkout's kernels, and times them with
*this* checkout's ``chip_smoke.py`` (its timers and input builders), so
both trees are timed alike even where the earlier ``chip_smoke.py`` has
no such timer. It prints JSON lines:

- ``kernels``: B2 at every timed shape of ``chip_smoke.py`` (gpt2-moe
  decode in float32 and bfloat16, gpt2-moe prompts of 16, 128 and 512
  tokens, qwen2-moe decode and 128 tokens) and B4 at the runtime's
  capture and calibration shapes and in bfloat16, each as device ms per
  call under both L2 flushes of ``chip_smoke.ColdTimer`` (``ms``: a
  64 MiB write before each call; ``ms_clean``: a 64 MiB read) and host
  ms per synchronised call; B2's rows also carry ``stream_ms`` and
  ``stream_ms_clean``, a ``torch.sum`` over as many bytes as B2 must
  read; then B1 at gpt2-moe decode, qwen2-moe decode and 1024 tokens;
- ``serve_gpt2``: ``chip_smoke.phase_serve`` on full-width gpt2-moe (its
  timed runs with and without telemetry, then its profiled runs);
- ``summary``: the decode step and TTFT of both timed serving runs;

and, last, the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--root", default=str(HERE),
                help="checkout whose src/ (kernels and model) is timed")
ARGS = ap.parse_args()
ROOT = Path(ARGS.root).resolve()
# the timed checkout's package first: chip_smoke (imported next) puts this
# checkout's src/ on the path, but the package is already loaded by then
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import repro_torch  # noqa: E402,F401
from repro_torch import get_arch  # noqa: E402

sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

GROUPED = [("gpt2-moe decode", cs.GPT2, cs.SLOTS, torch.float32),
           ("gpt2-moe decode bfloat16", cs.GPT2, cs.SLOTS, torch.bfloat16),
           *((f"gpt2-moe prefill N={n}", cs.GPT2, n, torch.float32)
             for n in cs.GROUPED_PROMPTS),
           ("qwen2-moe decode", cs.QWEN2, cs.SLOTS, torch.float32),
           ("qwen2-moe prefill N=128", cs.QWEN2, 128, torch.float32)]
CAPACITY = [("gpt2-capture", torch.float32),
            ("gpt2-calibrate", torch.float32),
            ("gpt2-capture", torch.bfloat16)]
ROUTER = [("gpt2-moe decode", cs.GPT2, cs.SLOTS),
          ("qwen2-moe decode", cs.QWEN2, cs.SLOTS),
          ("gpt2-moe N=1024", cs.GPT2, 1024)]


def both_flushes(timer, fn) -> dict:
    return {"ms": timer(fn), "ms_clean": timer(fn, clean=True),
            "host_ms": timer.host_ms(fn)}


def kernels(dev) -> dict:
    timer = cs.ColdTimer(dev)
    out: dict = {"grouped_moe_ffn": {}, "capacity_ffn": {},
                 "router_topk_fused": {}}
    for label, cfg, N, dtype in GROUPED:
        args, counts = cs.grouped_case(dev, dtype, N, cfg["D"], cfg["F"],
                                       cfg["E"], cfg["k"], cfg["activation"])
        fn = lambda: cs.grouped_moe_ffn(  # noqa: E731
            *args, activation=cfg["activation"])
        stream = cs.grouped_stream_tensors(args, counts)
        out["grouped_moe_ffn"][label] = {
            **both_flushes(timer, fn), "stream_ms": timer.stream(stream),
            "stream_ms_clean": timer.stream(stream, clean=True)}
        del args, stream
    for label, dtype in CAPACITY:
        E, C, D, F_, act = cs.CAPACITY_SHAPES[label]
        args = cs.capacity_case(dev, dtype, E, C, D, F_, act)
        out["capacity_ffn"][f"{label} {str(dtype)[6:]}"] = both_flushes(
            timer, lambda: cs.capacity_ffn(*args, activation=act))
        del args
    for label, cfg, N in ROUTER:
        t = cs.time_router(timer, dev, cfg, N=N)
        out["router_topk_fused"][label] = {"ms": t["ms"],
                                           "host_ms": t["host_ms"]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_checkout: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    assert Path(cs._build.__file__).resolve().is_relative_to(ROOT / "src")
    cs._build.build_all()
    print(json.dumps({"root": str(ROOT), "kernels": kernels(dev)}),
          flush=True)
    caught: list = []   # the fields of the serve_gpt2 line
    emit = cs.emit
    cs.emit = lambda phase, **f: (caught.append(f), emit(phase, **f))
    cs.phase_serve(dev, "serve_gpt2", get_arch("gpt2-moe"),
                   logits_check=False)
    cs.emit = emit
    runs = caught[-1]["runs"]
    print(json.dumps({"summary": {
        "root": str(ROOT),
        **{f"telemetry_{'on' if r['telemetry'] else 'off'}": {
            k: r[k] for k in ("decode_step_ms_mean", "ttft_ms_mean",
                              "prefill_ms_mean", "decode_tokens_per_s",
                              "wall_s")}
           for r in runs}}}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
