"""gpt2-moe — the paper's GPT2-based MoE model (§V-A).

GPT-2 [Radford et al. 2019] 12-layer decoder, each MLP converted to an MoE
layer with 4 experts, top-1 routing, learned positions, LayerNorm, GELU.
"""
from repro_torch.config import LayerSpec, MoEConfig, ModelConfig, register_arch


def gpt2_moe_config(num_experts: int = 4, top_k: int = 1) -> ModelConfig:
    return ModelConfig(
        name=f"gpt2-moe-{num_experts}e-top{top_k}",
        arch_type="moe",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=50257,
        pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=num_experts, top_k=top_k, d_expert_ff=3072),
        pos_embed="learned",
        norm="layernorm",
        activation="gelu",
        max_seq_len=1024,
        source="paper §V-A: GPT2 converted to MoE",
    )


@register_arch("gpt2-moe")
def config() -> ModelConfig:
    return gpt2_moe_config()
