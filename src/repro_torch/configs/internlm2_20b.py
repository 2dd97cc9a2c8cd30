"""internlm2-20b [dense]: GQA.  [arXiv:2403.17297]"""

from repro_torch.configs.base import ModelConfig, register


@register("internlm2-20b")
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16_384,
        vocab=92_544,
        rope_base=1_000_000.0,
        sparse_ffn=True,
    )
