"""Model configuration for the PyTorch port.

A copy of the reference package's configuration dataclasses
(``LayerSpec``, ``MoEConfig``, ``ModelConfig``) and of
``reduced_config``, so the port's tests can build the same reduced
models on both sides. The registry holds only the configurations the
port serves: ``gpt2-moe`` (the paper's model) and ``qwen2-moe-a2.7b``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

#: Mixer kinds a config may name. The port runs only "attn"; the others
#: raise in ``repro_torch.models.blocks`` (see ROADMAP.md, Queue A).
MIXER_KINDS = ("attn", "swa", "mamba2", "mlstm", "slstm", "shared_attn")

#: Feed-forward kinds.
FFN_KINDS = ("dense", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    """One transformer block = a sequence mixer + a feed-forward stage."""

    mixer: str = "attn"
    ffn: str = "dense"

    def __post_init__(self) -> None:
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"unknown mixer kind {self.mixer!r}")
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"unknown ffn kind {self.ffn!r}")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts settings for layers whose ``ffn == 'moe'``."""

    num_experts: int
    top_k: int
    d_expert_ff: int
    num_shared_experts: int = 0
    d_shared_ff: int = 0                  # per shared expert; 0 -> d_expert_ff
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01         # load-balance auxiliary loss
    router_z_coef: float = 1e-3
    dispatch: str = "dense"
    pipeline_degree: int = 1

    @property
    def shared_ff(self) -> int:
        return self.d_shared_ff or self.d_expert_ff


@dataclass(frozen=True)
class SSMConfig:
    """Recurrent-mixer settings (kept so configs round-trip; not run)."""

    state_size: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    mlstm_heads: int = 4
    slstm_heads: int = 4
    proj_factor: float = 2.0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an encoder-decoder model (kept; not run)."""

    num_layers: int
    num_heads: int
    d_ff: int
    source_len: int = 1500


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Full architecture description (same fields as the reference)."""

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0                    # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    qk_norm: bool = False
    sliding_window: int = 0
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"              # rope | learned | none
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    activation: str = "swiglu"           # swiglu | gelu
    tie_embeddings: bool = False
    causal: bool = True
    max_seq_len: int = 32_768
    frontend: str = "none"
    frontend_tokens: int = 0
    dtype: str = "bfloat16"
    source: str = ""
    supports_long_context: bool = False
    notes: str = ""

    def __post_init__(self) -> None:
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}")
        for spec in self.pattern:
            if spec.ffn == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: moe layer without MoEConfig")
            if spec.mixer in ("mamba2", "mlstm", "slstm") and self.ssm is None:
                raise ValueError(f"{self.name}: ssm mixer without SSMConfig")
            if spec.mixer == "swa" and self.sliding_window <= 0:
                raise ValueError(f"{self.name}: swa mixer without sliding_window")

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return _round_up(self.vocab_size, 256)

    @property
    def has_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.pattern)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        ARCH_REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported yet; the port serves "
            f"{sorted(ARCH_REGISTRY)} (the other families are queued in "
            "ROADMAP.md, Queue A)")
    return ARCH_REGISTRY[name]()


def reduced_config(cfg: ModelConfig, *, num_blocks: int = 2,
                   d_model: int = 256, max_experts: int = 4,
                   vocab: int = 512) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (the reference's rule)."""
    scale = d_model / cfg.d_model
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    hd = max(16, d_model // heads)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, max_experts),
            top_k=min(moe.top_k, 2),
            d_expert_ff=max(32, int(moe.d_expert_ff * scale)),
            num_shared_experts=min(moe.num_shared_experts, 1),
            d_shared_ff=max(32, int(moe.shared_ff * scale)),
        )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(
            ssm, state_size=min(ssm.state_size, 16), head_dim=32,
            chunk_size=64, mlstm_heads=2, slstm_heads=2)
    enc = cfg.encoder
    if enc is not None:
        enc = dataclasses.replace(enc, num_layers=2, num_heads=heads,
                                  d_ff=2 * d_model, source_len=16)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_blocks * len(cfg.pattern),
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=max(64, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        vocab_size=vocab,
        moe=moe,
        ssm=ssm,
        encoder=enc,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        max_seq_len=256,
        frontend_tokens=min(cfg.frontend_tokens, 16),
        dtype="float32",
    )
