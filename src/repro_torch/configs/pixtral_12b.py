"""pixtral-12b [vlm]: mistral-nemo backbone; pixtral-ViT frontend STUBBED —
input_specs() provides precomputed patch embeddings.  [hf:mistralai]"""

from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab=131_072,
        d_head=128,
        frontend="vision",
        rope_base=1_000_000.0,
        sparse_ffn=True,
    )
