"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8.  [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ModelConfig, MoECfg, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,                 # per-expert hidden
        vocab=151_936,
        moe=MoECfg(n_experts=128, top_k=8, d_expert=768),
        rope_base=1_000_000.0,
        sparse_ffn=True,
    )
