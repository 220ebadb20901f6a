"""Decoder-only model: embeddings -> block stack -> LM head.

Counterpart of ``repro.models.transformer`` for causal attention/MoE
decoders. Params are plain nested dicts with the reference's keys and
layouts: block params are stacked along a leading ``num_blocks`` axis
under ``params["blocks"]["pos{p}"]``, and a Python loop over that axis
replaces ``lax.scan``. Captures and caches come back stacked the same
way. The model lives on one device: CUDA unless ``device`` names another.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import ATTN_BACKENDS
from repro_torch.models.common import (Params, apply_norm, embed_init,
                                       init_norm)
from repro_torch.models.moe import (MOE_EXECUTORS, RoutingSummary,
                                    check_router_impl)
from repro_torch.params import tree_map


def tree_index(tree: Any, i: int) -> Any:
    """Block ``i`` of a tree stacked along a leading block axis (views)."""
    return tree_map(lambda t: t[i], tree)


def tree_stack(trees: List[Any]) -> Any:
    """Stack a list of per-block trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, RoutingSummary):
        return RoutingSummary(*[torch.stack(f) for f in zip(*trees)])
    return torch.stack(trees)


class Model:
    """Functional model bound to a :class:`ModelConfig` and a device."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 moe_executor: str = "dense", moe_router_impl: str = "fused",
                 attn_backend: str = "torch"):
        if cfg.is_encoder_decoder or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and frontend models are not "
                "ported yet (ROADMAP.md, Queue A)")
        for spec in cfg.pattern:
            B.check_spec(spec)
        if not cfg.causal:
            raise NotImplementedError(f"{cfg.name}: bidirectional encoders "
                                      "are not ported yet (ROADMAP.md)")
        if moe_executor not in MOE_EXECUTORS:
            raise ValueError(f"unknown MoE executor {moe_executor!r}")
        check_router_impl(moe_router_impl)
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"unknown attention backend {attn_backend!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # per-call overridable defaults, as in the reference
        self.moe_executor = moe_executor
        self.moe_router_impl = moe_router_impl
        self.attn_backend = attn_backend
        self.decode_dense_threshold = 4096

    # ------------------------------------------------------------------ init
    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Params:
        """Random weights from ``generator``, which must live on the model's
        device (sampling runs there). Float leaves are cast to ``dtype``."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg, gen = self.cfg, generator
        params: Params = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model)),
            "final_norm": init_norm(cfg.norm, cfg.d_model, device=self.device),
        }
        if cfg.pos_embed == "learned":
            params["pos_table"] = embed_init(gen, (cfg.max_seq_len,
                                                   cfg.d_model))
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, (cfg.d_model,
                                                 cfg.padded_vocab))
        params["shared"] = {}
        params["blocks"] = {
            f"pos{p}": B.init_block(gen, cfg, spec, (cfg.num_blocks,))
            for p, spec in enumerate(cfg.pattern)}
        return tree_map(
            lambda t: t.to(device=self.device,
                           dtype=dtype if t.is_floating_point() else t.dtype),
            params)

    def head_weight(self, params: Params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    # --------------------------------------------------------------- forward
    def forward(self, params: Params, tokens: torch.Tensor, *,
                capture: bool = False, return_cache: bool = False,
                moe_executor: Optional[str] = None,
                moe_router_impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
        """tokens (B, S). Returns (logits, aux, cache); ``aux`` carries the
        MoE losses, per-block expert counts and, under ``capture``, the
        stacked per-block captures."""
        cfg = self.cfg
        executor = moe_executor or self.moe_executor
        router_impl = moe_router_impl or self.moe_router_impl
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["embed"][tokens]
        S = x.shape[1]
        positions = torch.arange(S, device=self.device)
        if cfg.pos_embed == "learned":
            x = x + params["pos_table"][:S]
        caches: List[Dict[str, Any]] = []
        caps: List[Dict[str, Any]] = []
        for b in range(cfg.num_blocks):
            blk = tree_index(params["blocks"], b)
            cb, pb = {}, {}
            for p, spec in enumerate(cfg.pattern):
                x, c, cap = B.block_forward(
                    blk[f"pos{p}"], cfg, spec, x, positions=positions,
                    capture=capture, return_cache=return_cache,
                    moe_executor=executor, moe_router_impl=router_impl)
                cb[f"pos{p}"], pb[f"pos{p}"] = c, cap
            caches.append(cb)
            caps.append(pb)
        x = apply_norm(cfg.norm, params["final_norm"], x)
        stacked = tree_stack(caps)
        aux: Dict[str, Any] = {}
        lb = z = torch.zeros((), device=self.device)
        counts = []
        for p in range(len(cfg.pattern)):
            cp = stacked[f"pos{p}"]
            if "lb_loss" in cp:
                lb = lb + cp["lb_loss"].sum()
                z = z + cp["z_loss"].sum()
                counts.append(cp["expert_counts"])
        aux["lb_loss"], aux["z_loss"] = lb, z
        if counts:
            aux["expert_counts"] = torch.stack(counts, 1)  # (nb, n_pos, E)
        if capture:
            aux["captures"] = stacked
        cache = tree_stack(caches) if return_cache else None
        return x @ self.head_weight(params), aux, cache

    # --------------------------------------------------------------- serving
    def init_cache(self, batch: int, seq_len: int, *,
                   dtype=torch.float32) -> Dict[str, Any]:
        """Zero decode cache, stacked (num_blocks, ...) per unit position."""
        cfg = self.cfg
        return {f"pos{p}": B.init_block_cache(
                    cfg, spec, batch, seq_len, dtype=dtype,
                    device=self.device, lead=(cfg.num_blocks,))
                for p, spec in enumerate(cfg.pattern)}

    def prepare_decode_cache(self, cache: Dict[str, Any],
                             max_len: int) -> Dict[str, Any]:
        """Zero-pad prefill K/V (num_blocks, B, T, nkv, hd) to ``max_len``."""
        def pad(t: torch.Tensor) -> torch.Tensor:
            T = t.shape[2]
            if T >= max_len:
                return t
            out = t.new_zeros(t.shape[:2] + (max_len,) + t.shape[3:])
            out[:, :, :T] = t
            return out
        return tree_map(pad, cache)

    def prefill(self, params: Params, tokens: torch.Tensor, *,
                capture: bool = False, moe_executor: Optional[str] = None,
                moe_router_impl: Optional[str] = None):
        """Full-sequence pass returning (logits, cache), or (logits, cache,
        aux) under ``capture``."""
        logits, aux, cache = self.forward(
            params, tokens, return_cache=True, capture=capture,
            moe_executor=moe_executor, moe_router_impl=moe_router_impl)
        if capture:
            return logits, cache, aux
        return logits, cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Dict[str, Any], pos, *, capture: bool = False,
                    moe_executor: Optional[str] = None,
                    moe_router_impl: Optional[str] = None,
                    kv_len: Optional[int] = None,
                    attn_backend: Optional[str] = None):
        """One-token step. tokens (B, 1); ``pos`` an int or a (B,) tensor of
        per-slot positions. The cache is updated IN PLACE and returned.
        Returns (logits, cache) or (logits, cache, captures) under
        ``capture``, captures stacked (num_blocks, B, 1, ...)."""
        cfg = self.cfg
        executor = moe_executor or self.moe_executor
        router_impl = moe_router_impl or self.moe_router_impl
        backend = attn_backend or self.attn_backend
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = params["embed"][tokens]
        per_slot = torch.is_tensor(pos) and pos.dim() == 1
        if per_slot:
            pos = pos.to(device=self.device, dtype=torch.long)
        if cfg.pos_embed == "learned":
            # rows past the table are dead slots (the reference reads a
            # fill value there); clamp so they index in bounds
            last = cfg.max_seq_len - 1
            if per_slot:
                x = x + params["pos_table"][pos.clamp(0, last)][:, None]
            else:
                p0 = min(max(int(pos), 0), last)
                x = x + params["pos_table"][p0:p0 + 1]
        caps: List[Dict[str, Any]] = []
        for b in range(cfg.num_blocks):
            blk = tree_index(params["blocks"], b)
            blk_cache = tree_index(cache, b)
            pb = {}
            for p, spec in enumerate(cfg.pattern):
                x, _, cap = B.block_decode_step(
                    blk[f"pos{p}"], cfg, spec, x, blk_cache[f"pos{p}"],
                    pos=pos, capture=capture, moe_executor=executor,
                    moe_router_impl=router_impl,
                    dense_threshold=self.decode_dense_threshold,
                    kv_len=kv_len, attn_backend=backend)
                pb[f"pos{p}"] = cap
            caps.append(pb)
        x = apply_norm(cfg.norm, params["final_norm"], x)
        logits = x @ self.head_weight(params)
        if capture:
            return logits, cache, tree_stack(caps)
        return logits, cache
