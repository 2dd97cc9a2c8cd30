"""deepseek-coder-33b [dense]: llama-arch GQA.  [arXiv:2401.14196]"""

from repro_torch.configs.base import ModelConfig, register


@register("deepseek-coder-33b")
def deepseek_coder_33b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19_200,
        vocab=32_256,
        rope_base=100_000.0,
        sparse_ffn=True,
    )
