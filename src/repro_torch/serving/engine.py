"""Continuous-batching serving engine with live expert telemetry.

Counterpart of ``repro.serving.engine`` with the same public surface:
``submit``, ``run`` (``max_steps``, ``on_step``, ``arrivals``,
``round_tokens``, ``on_round``), ``step``, ``telemetry``,
``kv_len_bucket``, ``prefix_cache_size`` and the duck-typed
``predictor=`` and ``cache=`` hooks, so the reference's
``repro.plan.ServingBackend`` (which calls only ``submit``, ``run`` and
``telemetry``) drives it unchanged.

The engine owns a fixed number of decode *slots* backed by one
slot-batched KV cache (:class:`SlotKVCache`). Each request is prefilled
alone at its exact prompt length, copied into a free slot, and then
decoded in lock-step with every other live slot at its OWN position.
Queued requests are admitted mid-stream whenever a slot frees up.
Completion is EOS-aware; requests that exhaust ``max_new_tokens`` finish
with ``"length"`` and requests cut off by the step budget or KV capacity
with ``"truncated"``.

``kernels`` picks the hot path:

* ``"fused"`` (default) -- the fused router kernel, the grouped expert
  FFN kernel and, when telemetry is off, the flash-decode kernel, with
  ragged decode (attention reads only the bucketed longest live slot).
  Each wrapper launches its Hopper kernel for CUDA tensors and runs its
  plain PyTorch version for CPU tensors. Under telemetry the decode
  attention takes the dense path, which yields the attention IDs, as in
  the reference.
* ``"reference"`` -- the separate-pass router and full-buffer dense
  attention: the equivalence baseline.

The reference's ``"pallas"`` has no counterpart here and raises.

Frontend, encoder-decoder and recurrent configurations are not ported
(ROADMAP.md, Queue A) and raise.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dispatch.rounds import RoundAccumulator
from repro_torch.models.moe import RoutingSummary
from repro_torch.params import tree_map
from repro_torch.serving.kv_slots import SlotKVCache
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request, SlotScheduler
from repro_torch.serving.telemetry import ExpertTelemetry

ENGINE_KERNELS = ("fused", "reference")


def to_host(tree: Any) -> Any:
    """Captures on the device -> numpy (dicts, RoutingSummary, tensors)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, RoutingSummary):
        return RoutingSummary(*[to_host(f) for f in tree])
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


class ServingEngine:
    def __init__(self, model, params, *, max_len: int = 256,
                 batch_size: int = 4, eos_id: Optional[int] = None,
                 collect_telemetry: bool = True, prompt_bucket: int = 8,
                 moe_executor: str = "grouped", predictor=None,
                 cache=None, fair_aging: float = 64.0,
                 priority_aging: float = 0.0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 kernels: str = "fused", kv_len_bucket: int = 16,
                 prefix_cache_size: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        if kernels not in ENGINE_KERNELS:
            hint = (" (the port's hand-written kernels run under "
                    "kernels='fused')" if kernels == "pallas" else "")
            raise ValueError(f"kernels must be one of {ENGINE_KERNELS}, "
                             f"got {kernels!r}{hint}")
        if (self.cfg.is_encoder_decoder or self.cfg.frontend != "none"
                or any(s.mixer != "attn" for s in self.cfg.pattern)):
            raise NotImplementedError(
                f"{self.cfg.name}: frontend, encoder-decoder and recurrent "
                "serving paths are not ported yet (ROADMAP.md, Queue A)")
        self.kernels = kernels
        self._moe_router_impl = kernels
        self._ragged_decode = kernels != "reference"
        self.kv_len_bucket = max(1, kv_len_bucket)
        self.moe_executor = moe_executor if self.cfg.moe is not None \
            else None
        self.max_len = max_len
        self.batch_size = batch_size          # == number of decode slots
        self.num_slots = batch_size
        self.eos_id = eos_id
        self.scheduler = SlotScheduler(self.num_slots, aging=fair_aging,
                                       priority_aging=priority_aging,
                                       weights=tenant_weights)
        self.kv = SlotKVCache(model, self.num_slots, max_len)
        moe = self.cfg.moe
        self.telemetry: Optional[ExpertTelemetry] = (
            ExpertTelemetry(self.cfg.num_layers, moe.num_experts,
                            self.cfg.vocab_size, len(self.cfg.pattern))
            if collect_telemetry and moe is not None else None)
        self._capture = self.telemetry is not None
        # decode attention: the flash-decode kernel on the fused path (the
        # model takes the dense path instead whenever it captures)
        self._attn_backend = "kernel" if kernels == "fused" else "torch"
        if predictor is not None and self.telemetry is None:
            raise ValueError(
                "a predictor needs expert telemetry (an MoE model and "
                "collect_telemetry=True) to score and learn from")
        self.predictor = predictor
        self.last_prewarm_hints: Optional[np.ndarray] = None
        if cache is not None:
            if self.telemetry is None:
                raise ValueError(
                    "an expert-weight cache needs expert telemetry (an "
                    "MoE model and collect_telemetry=True) to track "
                    "residency against routed demand")
            if (cache.L, cache.E) != (self.cfg.num_layers,
                                      moe.num_experts):
                raise ValueError(
                    f"cache geometry {(cache.L, cache.E)} != model "
                    f"{(self.cfg.num_layers, moe.num_experts)}")
        self.cache = cache
        # prompt prefix cache: valid because the model is a causal
        # decoder-only stack (Model refuses anything else)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(prefix_cache_size) if prefix_cache_size > 0 else None)
        # right-padding a prompt is invisible only for causal dense
        # attention stacks; MoE layers route pads, so they prefill at
        # exact length (the reference's rule)
        safe = self.cfg.moe is None
        self.prompt_bucket = max(1, prompt_bucket) if safe else 1
        # per-slot decode state (host-side mirrors of the device cache)
        self.pos = np.zeros(self.num_slots, np.int32)       # next write pos
        self.cur_tok = np.zeros(self.num_slots, np.int32)   # next input tok
        self.seqs: List[np.ndarray] = [np.zeros(0, np.int64)
                                       for _ in range(self.num_slots)]
        self.step_count = 0
        self._finished: List[Request] = []

    # ------------------------------------------------------------ model calls
    @torch.no_grad()
    def _prefill(self, toks: np.ndarray, last_idx: int):
        tokens = torch.as_tensor(toks[None], device=self.device)
        if self._capture:
            logits, cache, aux = self.model.prefill(
                self.params, tokens, capture=True,
                moe_executor=self.moe_executor,
                moe_router_impl=self._moe_router_impl)
            caps = aux["captures"]
        else:
            logits, cache = self.model.prefill(
                self.params, tokens, moe_executor=self.moe_executor,
                moe_router_impl=self._moe_router_impl)
            caps = {}
        cache = self.model.prepare_decode_cache(cache, self.max_len)
        # last REAL token's logits, restricted to the valid vocab
        last = logits[0, last_idx, :self.cfg.vocab_size].float()
        return last.cpu().numpy(), cache, caps

    @torch.no_grad()
    def _decode(self, in_tok: np.ndarray, in_pos: np.ndarray,
                kv_len: Optional[int]):
        toks = torch.as_tensor(in_tok[:, None], device=self.device)
        pos = torch.as_tensor(in_pos, device=self.device)
        kw = dict(moe_executor=self.moe_executor,
                  moe_router_impl=self._moe_router_impl, kv_len=kv_len,
                  attn_backend=self._attn_backend)
        # the step writes the slot cache in place
        if self._capture:
            logits, _, caps = self.model.decode_step(
                self.params, toks, self.kv.cache, pos, capture=True, **kw)
        else:
            logits, _ = self.model.decode_step(
                self.params, toks, self.kv.cache, pos, **kw)
            caps = {}
        # never emit padding-vocab ids
        return logits[:, -1, :self.cfg.vocab_size], caps

    @torch.no_grad()
    def _prefix_step(self, tok: int, cache, pos: int):
        # batch-1 teacher-forced step on a private copy of a stored entry's
        # cache (decode writes in place; the entry must survive)
        logits, cache = self.model.decode_step(
            self.params, torch.tensor([[tok]], device=self.device), cache,
            pos, moe_executor=self.moe_executor,
            moe_router_impl=self._moe_router_impl)
        return logits[:, -1, :self.cfg.vocab_size], cache

    @property
    def pending(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return len(self.scheduler.queue)

    # --------------------------------------------------------------- submit
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               tenant: Optional[str] = None,
               priority: int = 0) -> Request:
        prompt = np.asarray(prompt, np.int32).ravel()
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens does not fit "
                             f"max_len={self.max_len}")
        return self.scheduler.submit(prompt, max_new_tokens, eos_id=eos_id,
                                     tenant=tenant, priority=priority,
                                     submit_step=self.step_count)

    # ------------------------------------------------------------ admission
    def _sliced_prefill_captures(self, caps, true_len: int) -> Dict:
        """Trim captures to the real token span (right-pad positions of
        bucketed prompts) so feature extraction sees token-aligned arrays."""
        out = {}
        for key, cap in caps.items():
            c = dict(cap)
            if "topk_idx" in c:
                c["topk_idx"] = c["topk_idx"][:, :, :true_len]
                c["topk_weight"] = c["topk_weight"][:, :, :true_len]
            if "attn_argmax" in c:
                c["attn_argmax"] = c["attn_argmax"][:, :, :true_len]
            out[key] = c
        return out

    def _finish(self, req: Request, reason: str) -> None:
        self.scheduler.finish(req, reason)
        self._finished.append(req)

    def _admit(self) -> bool:
        """Prefill queued requests into free slots. Returns True if any."""
        admitted = False
        while self.scheduler.queue:
            free = self.scheduler.free_slots()
            if not free:
                break
            slot = free[0]
            req = self.scheduler.admit_next(slot, self.step_count)
            assert req is not None
            true_len = len(req.prompt)
            pc_kind, pc_entry = "miss", None
            if self.prefix_cache is not None:
                pc_kind, pc_entry = self.prefix_cache.lookup(req.prompt)
                if pc_kind == "prefix" and self.telemetry is not None:
                    # extension teacher-forces the suffix without capture,
                    # so it cannot replay routing records — with telemetry
                    # on, only exact hits skip the prefill
                    pc_kind, pc_entry = "miss", None
            caps_sliced: Dict[str, Any] = {}
            if pc_kind == "exact":
                self.kv.insert(pc_entry.cache, slot, length=true_len)
                last_np = pc_entry.last_logits
                caps_sliced = pc_entry.caps or {}
            elif pc_kind == "prefix":
                # decode writes in place; the stored entry must survive
                cache = tree_map(torch.clone, pc_entry.cache)
                logits = None
                for t in range(len(pc_entry.prompt), true_len):
                    logits, cache = self._prefix_step(
                        int(req.prompt[t]), cache, t)
                last_np = logits.float().cpu().numpy()[0]
                self.prefix_cache.put(req.prompt, cache, last_np)
                self.kv.insert(cache, slot, length=true_len)
            else:
                bucket = self.prompt_bucket
                padded = min(-(-true_len // bucket) * bucket, self.max_len)
                toks = np.zeros(padded, np.int32)
                toks[:true_len] = req.prompt
                last_np, cache, caps = self._prefill(toks, true_len - 1)
                self.kv.insert(cache, slot, length=true_len)
                if self.telemetry is not None:
                    caps_sliced = self._sliced_prefill_captures(
                        to_host(caps), true_len)
                if self.prefix_cache is not None:
                    self.prefix_cache.put(
                        req.prompt, cache, last_np,
                        caps_sliced if self.telemetry is not None
                        else None)
            self.pos[slot] = true_len
            if self.telemetry is not None:
                mark = self.telemetry.num_records
                self.telemetry.record_prefill(req.prompt[None], caps_sliced)
                if self.predictor is not None:
                    self.predictor.observe_tokens(req.prompt)
                    self.predictor.update_records(
                        self.telemetry.records_since(mark))
            first = int(last_np.argmax())
            req.first_token_time = time.perf_counter()
            if req.max_new_tokens < 1:
                self.seqs[slot] = req.prompt.astype(np.int64)
                self._finish(req, "length")
                self.kv.release(slot)
            else:
                req.output.append(first)
                self.seqs[slot] = np.append(req.prompt.astype(np.int64),
                                            first)
                self.cur_tok[slot] = first
                eos = req.eos_id if req.eos_id is not None else self.eos_id
                if eos is not None and first == eos:
                    self._finish(req, "eos")
                    self.kv.release(slot)
                elif len(req.output) >= req.max_new_tokens:
                    self._finish(req, "length")
                    self.kv.release(slot)
            admitted = True
        return admitted

    # ------------------------------------------------------------------ step
    def step(self) -> bool:
        """Admit queued requests, then advance every live slot one token.

        Returns False when there was nothing to do."""
        self._admit()
        active = [i for i, r in enumerate(self.scheduler.slots)
                  if r is not None]
        if not active:
            return False
        in_tok = self.cur_tok.copy()
        in_pos = self.pos.copy()
        # speculative dispatch: hints from the step's INPUT tokens
        hints = None
        if self.predictor is not None:
            act_tok = in_tok[np.asarray(active, np.int64)]
            hints = self.predictor.prewarm_hint_matrix(act_tok)
            self.last_prewarm_hints = hints
        if self.cache is not None and hints is not None:
            self.cache.prefetch(hints)
        # ragged decode: an attention bound covering the longest live slot
        # AFTER this step's write, rounded up to kv_len_bucket
        kv_len = None
        if self._ragged_decode:
            need = self.kv.max_valid_len() + 1
            b = self.kv_len_bucket
            kv_len = min(-(-need // b) * b, self.max_len)
        logits, caps = self._decode(in_tok, in_pos, kv_len)
        if self.telemetry is not None:
            caps_h = to_host(caps)
            demand_before = (self.telemetry.demand.copy()
                             if hints is not None or self.cache is not None
                             else None)
            mark = self.telemetry.num_records
            self.telemetry.record_decode(in_tok, in_pos, self.seqs, caps_h,
                                         active, n_front=0)
            if self.cache is not None:
                self.cache.serve_demand(
                    self.telemetry.demand - demand_before)
            if hints is not None:
                self.telemetry.record_prewarm(
                    hints, self.telemetry.demand - demand_before)
                self.predictor.observe_tokens(
                    in_tok[np.asarray(active, np.int64)])
                self.predictor.update_records(
                    self.telemetry.records_since(mark))
        nxt = logits.argmax(-1).cpu().numpy()
        for i in active:
            req = self.scheduler.slots[i]
            assert req is not None
            tok = int(nxt[i])
            req.output.append(tok)
            self.seqs[i] = np.append(self.seqs[i], tok)
            self.pos[i] += 1
            self.cur_tok[i] = tok
            self.kv.set_length(i, int(self.pos[i]))
            eos = req.eos_id if req.eos_id is not None else self.eos_id
            if eos is not None and tok == eos:
                self._finish(req, "eos")
                self.kv.release(i)
            elif len(req.output) >= req.max_new_tokens:
                self._finish(req, "length")
                self.kv.release(i)
            elif self.pos[i] >= self.max_len:
                self._finish(req, "truncated")   # KV capacity exhausted
                self.kv.release(i)
        self.step_count += 1
        return True

    # ------------------------------------------------------------ speculation
    def speculation_stats(self) -> Dict[str, Any]:
        """Scoreboard of the speculative dispatch stage (``hit_rate`` is
        None before any scored decode step)."""
        tel = self.telemetry
        if tel is None:
            raise ValueError("speculation stats need expert telemetry")
        per_layer = np.divide(
            tel.prewarm_hits_by_layer, tel.prewarm_pairs_by_layer,
            out=np.zeros_like(tel.prewarm_hits_by_layer),
            where=tel.prewarm_pairs_by_layer > 0)
        return {
            "hits": tel.prewarm_hits,
            "misses": tel.prewarm_misses,
            "pairs": tel.prewarm_pairs,
            "hit_rate": tel.prewarm_hit_rate(),
            "per_layer_hit_rate": per_layer.tolist(),
        }

    def residency_stats(self) -> Dict[str, Any]:
        """Scoreboard of the attached expert-weight cache."""
        if self.cache is None:
            raise ValueError("residency stats need an expert-weight "
                             "cache (ServingEngine(cache=...))")
        return self.cache.residency_stats()

    # ------------------------------------------------------------------- run
    def run(self, *, max_steps: int = 256, on_step=None,
            round_tokens: int = 0, on_round=None,
            arrivals=None) -> List[Request]:
        """Serve until queue and slots drain (or ``max_steps`` decode steps).

        Same contract as the reference: ``on_step(engine, step_index)``
        after every decode step; requests still holding slots when the
        budget runs out finish ``"truncated"``, requests never admitted
        stay queued; ``round_tokens > 0`` (needs telemetry) closes a
        dispatch round and fires ``on_round(engine, {"steps", "tokens"})``
        once that many tokens were served since it opened; ``arrivals``
        (objects with ``arrival_step``/``prompt``/``max_new_tokens``) are
        submitted as the arrival clock reaches them, idle gaps
        fast-forward the clock without spending decode budget, and
        arrivals still due at the end are queued. Returns the requests
        finished during this call, in completion order."""
        if round_tokens and self.telemetry is None:
            raise ValueError("round_tokens requires expert telemetry")
        mark = len(self._finished)
        rounds = RoundAccumulator(
            round_tokens,
            start_tokens=(self.telemetry.total_tokens
                          if self.telemetry is not None else 0),
            on_round=on_round)

        queue_arr = sorted(arrivals, key=lambda r: r.arrival_step) \
            if arrivals else []
        arr_i = 0

        def _submit_due(step: int) -> None:
            nonlocal arr_i
            while arr_i < len(queue_arr) \
                    and queue_arr[arr_i].arrival_step <= step:
                r = queue_arr[arr_i]
                self.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                            tenant=getattr(r, "tenant", None),
                            priority=getattr(r, "priority", 0))
                arr_i += 1

        def _tokens() -> int:
            return (self.telemetry.total_tokens
                    if self.telemetry is not None else 0)

        _submit_due(0)
        self._admit()      # prefill-only / instant-EOS requests complete here
        steps = 0          # decode budget: real decode steps only
        clock = 0          # arrival time
        while steps < max_steps:
            _submit_due(clock)
            if not self.scheduler.has_work:
                if arr_i < len(queue_arr):
                    clock = max(clock + 1,
                                queue_arr[arr_i].arrival_step)
                    continue
                break
            if not self.step():
                continue
            steps += 1
            clock += 1
            rounds.record_step()
            if on_step is not None:
                on_step(self, steps)
            if rounds.due(_tokens()):
                rounds.close(_tokens(), self)
        if rounds.pending(_tokens()):
            rounds.close(_tokens(), self)  # final partial round
        while arr_i < len(queue_arr):
            r = queue_arr[arr_i]
            self.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                        tenant=getattr(r, "tenant", None),
                        priority=getattr(r, "priority", 0))
            arr_i += 1
        if self.scheduler.has_work:
            for i, slot_req in enumerate(self.scheduler.slots):
                if slot_req is not None:
                    self.kv.release(i)
            for req in list(self.scheduler.active()):
                self._finish(req, "truncated")
        return self._finished[mark:]
