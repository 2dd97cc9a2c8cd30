"""granite-moe-3b-a800m [moe]: 40 experts, top-8.  [hf:ibm-granite]"""

from repro_torch.configs.base import ModelConfig, MoECfg, register


@register("granite-moe-3b-a800m")
def granite_moe_3b() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,                 # per-expert hidden
        vocab=49_155,
        moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
        sparse_ffn=True,
    )
