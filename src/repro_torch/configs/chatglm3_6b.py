"""chatglm3-6b [dense]: 2D/partial RoPE (half the head dim), GQA kv=2.
[arXiv:2406.12793]"""

from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13_696,
        vocab=65_024,
        rope_fraction=0.5,
    )
